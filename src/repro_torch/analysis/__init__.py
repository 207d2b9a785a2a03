"""repro_torch.analysis — the serving invariant rules S301-S307
(:mod:`repro_torch.analysis.rules`).  The rest of the JAX package's
``analysis/`` (plan checkers, diagnostics) arrives with the static verifier
(ROADMAP Queue 1, "Static verifier")."""
