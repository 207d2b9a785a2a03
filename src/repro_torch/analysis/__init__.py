"""repro_torch.analysis — static verification of execution plans, kernel
contracts, and serving invariants.

The paper's compilation flow is safe to automate because every optimization
is checked before synthesis; this package is that gate for the port.
``verify_plan(plan)`` runs a suite of declarative checkers over a built
:class:`~repro_torch.core.plan.ExecutionPlan` *without launching anything*
and returns structured :class:`Diagnostic` objects (stable code, severity,
provenance).  It is wired in three places:

* ``repro_torch.flow.compile(verify=True)`` raises
  :class:`PlanVerificationError` with the full diagnostic list before any
  weight is made;
* ``repro_torch.core.dse.explore`` statically prunes invalid candidates
  before they are validated (``ExploreResult.n_static_pruned``);
* ``python -m repro_torch.launch.check --all`` runs it from CI over the
  plans the card would run (no card needed).

:mod:`repro_torch.analysis.rules` is additionally the single source of
truth for the serving/mesh invariants that ``EngineConfig.__post_init__``,
``ServingProfile`` and ``split_rejection_reason`` raise.
"""
from repro_torch.analysis.diagnostics import (  # noqa: F401
    DIAGNOSTIC_CODES, ERROR, WARNING, Diagnostic, PlanVerificationError,
    VerificationResult)
from repro_torch.analysis.checkers import (  # noqa: F401
    CHECKERS, static_flow_diagnostics, verify_engine_config, verify_pipeline,
    verify_plan)
from repro_torch.analysis import rules  # noqa: F401

__all__ = [
    "CHECKERS", "DIAGNOSTIC_CODES", "Diagnostic", "ERROR",
    "PlanVerificationError", "VerificationResult", "WARNING", "rules",
    "static_flow_diagnostics", "verify_engine_config", "verify_pipeline",
    "verify_plan",
]
