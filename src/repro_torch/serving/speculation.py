"""Speculative decoding over the paged KV pool: draft -> verify -> rollback.

One verify tick amortizes a model step over up to ``draft_k + 1`` tokens: a
drafter proposes ``j <= draft_k`` continuation tokens for a slot, the engine
feeds ``[last_token, d_1..d_j]`` as one row of the same ``(B, k)`` cell the
chunked catch-up path uses (``paged_decode_attention`` with explicit
``qpos`` — the mask is purely positional, so the speculative columns score
exactly as a sequential replay would), and every column's logits come back
at once.  Acceptance is *sample-from-target*: column ``c`` is sampled (or
argmaxed, at temperature 0) into the target token ``x_c``; draft ``d_{c+1}``
is accepted iff it equals ``x_c``, and the committed tokens of the tick are
``x_0..x_r`` where ``r`` is the first mismatch (or ``j``, the bonus token,
on accept-all).  Every emitted token is therefore a true sample from the
target model's distribution given its committed prefix — the standard
rejection-sampling identity specialized to deterministic drafters — which
gives two hard guarantees the tests pin down:

* greedy speculative output is **byte-identical** to the 1-token host loop
  (argmax doesn't care how many columns the tick carried);
* sampled speculative output is **drafter-invariant**: the token at commit
  index ``t`` of request ``serial`` is a Gumbel-max draw whose noise is a
  pure function of ``(seed, serial, t)`` (:func:`sample_targets`), so any
  drafter — including the null drafter that proposes nothing — produces
  the same byte stream.

Rejected columns leave garbage K/V behind the committed length; it is never
attended (the causal positional mask only admits ``kpos <= qpos`` and later
writes overwrite it first), but the device-side lengths and the ledger must
roll back — :meth:`repro_torch.serving.kvcache.BlockLedger.spec_begin` /
``spec_commit`` snapshot and truncate, undoing COW forks that served only
rejected tokens so the pool never leaks under partial acceptance.

Drafters are advisory: a wrong (or out-of-vocab) proposal only lowers the
acceptance rate, never changes output.  Built-ins:

* :class:`NGramDrafter` — prompt-lookup: propose the continuation of the
  most recent earlier occurrence of the history's trailing n-gram (free;
  strong on shared-prefix and self-repetitive decode);
* :class:`DraftModelDrafter` — a small registered config compiled through
  the port's ``flow.compile`` and rolled greedily ``k`` tokens;
* :class:`NullDrafter` — proposes nothing (the sampled-parity baseline).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

_EMPTY = np.empty(0, np.int32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SpeculationConfig:
    """The ``EngineConfig.speculation`` knob: which drafter, how many draft
    tokens per verify tick.  Invariants (kind, draft_k vs the envelope, the
    fori_seg clash) live in ``repro_torch.analysis.rules.speculation_valid`` —
    diagnostic S307."""
    kind: str = "ngram"                # "ngram" | "draft" | "null"
    draft_k: int = 4                   # drafts per verify tick (cell is k+1)
    draft_cfg: Optional[str] = None    # registered config name (kind="draft")
    ngram_max: int = 3                 # longest trailing n-gram to look up
    ngram_min: int = 1

    @classmethod
    def parse(cls, text: str) -> Optional["SpeculationConfig"]:
        """``"ngram:4" | "draft:<cfg>:4" | "null:2" | "off"`` (CLI form)."""
        t = text.strip()
        if t in ("", "off", "none"):
            return None
        parts = t.split(":")
        if parts[0] == "draft":
            if len(parts) != 3:
                raise ValueError(
                    f"speculation spec {text!r}: expected draft:<cfg>:<k>")
            return cls(kind="draft", draft_cfg=parts[1],
                       draft_k=int(parts[2]))
        if len(parts) > 2:
            raise ValueError(
                f"speculation spec {text!r}: expected <kind>:<k> or off")
        k = int(parts[1]) if len(parts) == 2 else 4
        return cls(kind=parts[0], draft_k=k)

    def describe(self) -> str:
        if self.kind == "draft":
            return f"draft:{self.draft_cfg}:{self.draft_k}"
        return f"{self.kind}:{self.draft_k}"


# ---------------------------------------------------------------------------
# target sampling (the rng streams the exactness guarantee hangs on)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two multiply-xorshift rounds) on int64
    tensors holding values in [0, 2**32): every product stays below
    2**59, so the bytes are the same on the CPU and the card."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def sample_targets(logits: torch.Tensor, seed: int, serials: torch.Tensor,
                   t0s: torch.Tensor, temperature: float) -> torch.Tensor:
    """Per-request counter-mode target sampling for the verify cell.

    Row ``i``, column ``c`` is ``argmax(logits / temperature + g)`` with
    Gumbel noise ``g[v] = -log(-log(u[v]))``, ``u`` a hash of
    ``(seed, serials[i], t0s[i] + c, v)`` — a pure function of (request
    serial, commit index), independent of how many columns this tick
    carried, which slots shared it, or what any drafter proposed.  That
    makes sampled speculative output drafter-invariant byte for byte.
    (The JAX package draws with threefry keys, which torch cannot
    reproduce; the two packages' sampled streams differ.)  ``logits``:
    (B, K, V); ``serials``/``t0s``: (B,) integer tensors; returns (B, K)
    int32 targets on the logits' device."""
    B, K, V = logits.shape
    dev = logits.device
    s = _mix32(torch.tensor(int(seed) & _M32, dtype=torch.int64,
                            device=dev))
    s = _mix32(s ^ (serials.to(dev, torch.int64) & _M32))           # (B,)
    col = torch.arange(K, dtype=torch.int64, device=dev)
    s = _mix32(s[:, None] ^ ((t0s.to(dev, torch.int64)[:, None] + col)
                             & _M32))                                # (B, K)
    vh = _mix32(torch.arange(V, dtype=torch.int64, device=dev)
                * 0x9E3779B1 & _M32)
    bits = _mix32(s[:, :, None] ^ vh) >> 8                           # 24 bits
    u = (bits.double() + 0.5) * 2.0 ** -24
    g = -torch.log(-torch.log(u))
    return torch.argmax(logits.double() / temperature + g, dim=-1).to(
        torch.int32)


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

class Drafter:
    """Drafter protocol: ``propose(history, k)`` returns up to ``k`` int32
    continuation tokens for a request whose committed tokens (prompt +
    generated) are ``history``.  Proposals are advisory — they steer the
    acceptance rate, never the output."""
    kind = "base"

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NullDrafter(Drafter):
    """Proposes nothing: every tick degrades to a plain 1-token decode.
    Exists as the baseline for the sampled drafter-invariance tests."""
    kind = "null"

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        return _EMPTY


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: find the most recent earlier occurrence of
    the history's trailing n-gram (longest n first) and propose the tokens
    that followed it.  When the continuation runs off the end of history
    (the most recent match sits near the tail — always the case once decode
    settles into a short repetition cycle), the drafted tokens are appended
    to the lookup window and the search repeats, so a period-p cycle drafts
    all ``k`` tokens instead of truncating at the tail.  Zero model cost;
    strong whenever decode revisits its own context — shared system
    prompts, code, repetitive spans."""
    kind = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, "
                             f"got ({min_n}, {max_n})")
        self.max_n = max_n
        self.min_n = min_n

    def _lookup(self, h: np.ndarray, k: int) -> np.ndarray:
        H = int(h.size)
        for n in range(min(self.max_n, H - 1), self.min_n - 1, -1):
            pat = h[H - n:]
            # candidate starts 0..H-1-n: a match must have at least one
            # continuation token, and the trailing gram itself (start H-n)
            # is excluded
            w = np.lib.stride_tricks.sliding_window_view(h, n)[:H - n]
            hits = np.nonzero((w == pat).all(axis=1))[0]
            if hits.size:
                s = int(hits[-1])
                return h[s + n: s + n + k]
        return _EMPTY

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int64).reshape(-1)
        if h.size < 2 or k < 1:
            return _EMPTY
        out = self._lookup(h, k)
        # each extension round drafts >= 1 token or breaks, so this
        # terminates after at most k rounds
        while 0 < out.size < k:
            ext = self._lookup(np.concatenate([h, out]), k - int(out.size))
            if not ext.size:
                break
            out = np.concatenate([out, ext])
        return out.astype(np.int32)


class DraftModelDrafter(Drafter):
    """A small registered config compiled via the port's ``flow.compile``
    and rolled greedily: one right-padded prefill over the history, then
    ``k - 1`` single-token decode steps through its own rolling cache.
    Out-of-vocab proposals (draft vocab larger than the target's) are
    truncated by the engine — like every drafter, this one is advisory
    only.  Its weights are the port's own random weights from seed 0."""
    kind = "draft"

    def __init__(self, draft_cfg: Any, *, max_seq_len: int,
                 smoke: bool = False, device: Any = None):
        from repro_torch import flow as tflow
        from repro_torch.configs.base import FlowConfig, ShapeConfig
        self.cm = tflow.compile(
            draft_cfg, ShapeConfig("spec_draft", "decode", max_seq_len, 1),
            FlowConfig(mode="folded", precision="fp32"), smoke=smoke,
            device=device)
        self.params = self.cm.init_params(0)
        self.cache_len = self.cm.plan.cache_len

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int32).reshape(-1)
        L = int(h.size)
        k = min(k, self.cache_len - L)
        if L < 1 or k < 1:
            return _EMPTY
        dev = self.cm.device
        # the port's prefill returns the last position's logits: run it
        # over the L history tokens (no right-padding)
        logits, state, _ = self.cm.prefill(
            self.params, {"tokens": torch.from_numpy(
                h.astype(np.int64)[None]).to(dev)})
        out = [int(torch.argmax(logits[0, -1]))]
        for t in range(1, k):
            lg, state, _ = self.cm.decode(
                self.params,
                {"tokens": torch.tensor([[out[-1]]], device=dev)},
                state, L + t - 1)
            out.append(int(torch.argmax(lg[0, -1])))
        return np.asarray(out, np.int32)


def build_drafter(spec: SpeculationConfig, *, max_seq_len: int,
                  target_cfg: Any = None, device: Any = None) -> Drafter:
    """Instantiate the drafter a :class:`SpeculationConfig` names.  The
    draft-model drafter inherits the target's smoke-ness so the smoke
    models draft against smoke-sized configs, and runs on ``device``."""
    if spec.kind == "ngram":
        return NGramDrafter(spec.ngram_max, spec.ngram_min)
    if spec.kind == "null":
        return NullDrafter()
    if spec.kind == "draft":
        return DraftModelDrafter(spec.draft_cfg, max_seq_len=max_seq_len,
                                 smoke=_is_smoke(target_cfg), device=device)
    raise ValueError(f"unknown drafter kind {spec.kind!r}")


def _is_smoke(cfg: Any) -> bool:
    if cfg is None:
        return False
    from repro_torch.configs import get_smoke
    try:
        return get_smoke(cfg.name) == cfg
    except KeyError:
        return False
