"""The port's attention kernels' plain versions against the JAX package's
Pallas kernels (run in interpret mode on the CPU) and its ``kernels/ref.py``
oracles, on the same numpy inputs; and the port's reference attention op
(``_sdpa``) against the JAX one.

The wrappers ``flash_attention`` and ``decode_attention`` are called with
CPU tensors, so they run their plain versions (the CUDA kernels themselves
are held against those plain versions on the card, in
``tests/test_torch_gpu.py``).

Tolerances (``conftest.relerr``: max |diff| over max |ref|):
* fp32 < 1e-5 — the same fp32 arithmetic, summed in another order;
* bf16 < 2e-2 — both compute in fp32 from the same bf16 inputs, and the one
  bf16 rounding of the output may land on the other side.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.core import ops_impl as jops_impl
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ops_impl as tops_impl
from repro_torch.kernels import attention as tatt
from repro_torch.kernels import decode_attention as tdec

TOL = {"fp32": 1e-5, "bf16": 2e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}

# (B, Sq, Skv, H, KV, D, causal, window, q_offset) — the cases of
# tests/test_kernels.py: windows, a q offset, a ragged bidirectional length,
# GQA
FLASH = {
    "causal": (2, 64, 64, 4, 4, 32, True, None, 0),
    "window": (1, 48, 48, 4, 2, 16, True, 16, 0),
    "q_offset": (2, 32, 96, 6, 2, 32, True, None, 64),
    "bidir_ragged": (1, 100, 100, 2, 1, 64, False, None, 0),
    "gqa_window": (2, 128, 128, 8, 8, 64, True, 32, 0),
}
# (B, C, H, KV, D, window), half the cache filled, the rest pos = -1
DECODE = {
    "gqa": (2, 64, 4, 2, 32, None),
    "mqa_window": (1, 96, 8, 1, 64, 32),
    "mha": (3, 40, 4, 4, 16, None),
}


def _pair(a, dt):
    """The same numpy array as a JAX array and a torch tensor of dtype dt
    (bf16 goes through fp32 on both sides, so the values are identical)."""
    j = jnp.asarray(a, jnp.float32).astype(JDT[dt])
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dt])
    return j, t


def _qkv(rng, B, Sq, Skv, H, KV, D, dt):
    return [_pair(rng.randn(*s).astype(np.float32), dt)
            for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D))]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_plain_matches_pallas_interpret(name):
    B, Sq, Skv, H, KV, D, causal, win, off = FLASH[name]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(0), B, Sq, Skv,
                                        H, KV, D, "fp32")
    y = tatt.flash_attention(tq, tk, tv, causal=causal, window=win,
                             q_offset=off)
    j = jops.flash_attention(jq, jk, jv, causal=causal, window=win,
                             q_offset=off, tile=(32, 32), interpret=True)
    assert y.shape == (B, Sq, H, D) and y.dtype == torch.float32
    assert relerr(_np(y), j) < TOL["fp32"]


@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_plain_matches_ref(name):
    B, Sq, Skv, H, KV, D, causal, win, off = FLASH[name]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(1), B, Sq, Skv,
                                        H, KV, D, "fp32")
    y = tatt.flash_attention_plain(tq, tk, tv, causal=causal, window=win,
                                   q_offset=off, softcap=20.0)
    j = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=win,
                                 q_offset=off, softcap=20.0)
    assert relerr(_np(y), j) < TOL["fp32"]


@pytest.mark.parametrize("dt", sorted(TOL))
def test_flash_dtypes(dt):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(2), 2, 64, 64,
                                        4, 2, 32, dt)
    y = tatt.flash_attention(tq, tk, tv)
    assert y.dtype == TDT[dt]
    j = jops.flash_attention(jq, jk, jv, tile=(32, 32), interpret=True)
    assert relerr(_np(y), j) < TOL[dt]
    assert relerr(_np(y), jref.flash_attention_ref(jq, jk, jv)) < TOL[dt]


@pytest.mark.parametrize("dt", sorted(TOL))
def test_flash_positions_with_padding(dt):
    """Left-padded rows (the serving engine's bucketed prefill): positions
    -1 on the padding.  Valid query rows agree; pad rows are garbage the
    caller discards, and are not compared."""
    B, S, H, KV, D = 3, 40, 4, 2, 16
    pad = np.array([0, 3, 25])
    ar = np.arange(S)
    pos = np.where(ar[None] >= pad[:, None], ar[None] - pad[:, None],
                   -1).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(3), B, S, S, H,
                                        KV, D, dt)
    tp = torch.from_numpy(pos)
    y = tatt.flash_attention(tq, tk, tv, positions=tp, window=24)
    j = jops.flash_attention(jq, jk, jv, jnp.asarray(pos), window=24,
                             tile=(16, 16), interpret=True)
    r = jref.flash_attention_ref(jq, jk, jv, positions=jnp.asarray(pos),
                                 window=24)
    keep = pos >= 0
    yk = _np(y)[keep]
    assert relerr(yk, np.asarray(j, np.float32)[keep]) < TOL[dt]
    assert relerr(yk, np.asarray(r, np.float32)[keep]) < TOL[dt]


def test_flash_wrapper_checks_its_arguments():
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="positions"):
        tatt.flash_attention(q, k, k, positions=torch.zeros(1, 7))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tatt.flash_attention(q, k, k, positions=torch.zeros(1, 8),
                             q_offset=3)
    with pytest.raises(ValueError, match="KV dividing H"):
        tatt.flash_attention(q, torch.zeros(1, 8, 3, 16),
                             torch.zeros(1, 8, 3, 16))


@pytest.mark.parametrize("D", tatt.HEAD_DIMS)
@pytest.mark.parametrize("dt", sorted(TOL))
def test_flash_schedule(dt, D):
    """At head widths 64, 128 and 256 bf16 on the wgmma kernel and fp32
    (full fp32, no TF32) on the ffma kernel; both at 16 and 32 on the SIMT
    kernel."""
    want = "simt" if D < 64 else "wgmma" if dt == "bf16" else "ffma"
    assert tatt._schedule(TDT[dt], D) == want


def test_flash_wrapper_carries_schedules():
    """The wrapper counts launches by schedule beside its total; on CPU
    tensors it runs the plain version and neither count moves."""
    assert set(tatt.flash_attention.schedules) == set(tatt.SCHEDULES)
    before = (tatt.flash_attention.launches,
              dict(tatt.flash_attention.schedules))
    q, k = torch.randn(1, 8, 4, 64).bfloat16(), torch.randn(1, 8, 2, 64)
    k = k.bfloat16()
    assert torch.equal(tatt.flash_attention(q, k, k),
                       tatt.flash_attention_plain(q, k, k))
    assert (tatt.flash_attention.launches,
            tatt.flash_attention.schedules) == before


def _cache(rng, B, C, H, KV, D, dt):
    fill = C // 2
    pos = np.where(np.arange(C)[None] < fill, np.arange(C)[None], -1)
    pos = np.broadcast_to(pos, (B, C)).astype(np.int32)
    q = _pair(rng.randn(B, 1, H, D).astype(np.float32), dt)
    kc = _pair(rng.randn(B, C, KV, D).astype(np.float32), dt)
    vc = _pair(rng.randn(B, C, KV, D).astype(np.float32), dt)
    qpos = np.full((B, 1), fill, np.int32)
    return q, kc, vc, pos, qpos


@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_plain_matches_pallas_interpret_and_ref(name, dt):
    B, C, H, KV, D, win = DECODE[name]
    (jq, tq), (jk, tk), (jv, tv), pos, qpos = _cache(
        np.random.RandomState(4), B, C, H, KV, D, dt)
    y = tdec.decode_attention(tq, tk, tv, torch.from_numpy(pos),
                              torch.from_numpy(qpos), window=win)
    assert y.shape == (B, 1, H, D) and y.dtype == TDT[dt]
    j = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(qpos),
                              window=win, tile=32, interpret=True)
    r = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(pos),
                                  jnp.asarray(qpos), window=win)
    assert relerr(_np(y), j) < TOL[dt]
    assert relerr(_np(y), r) < TOL[dt]


def test_decode_plain_softcap_matches_ref():
    (jq, tq), (jk, tk), (jv, tv), pos, qpos = _cache(
        np.random.RandomState(5), 2, 64, 4, 2, 32, "fp32")
    y = tdec.decode_attention_plain(tq, tk, tv, torch.from_numpy(pos),
                                    torch.from_numpy(qpos), softcap=5.0)
    r = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(pos),
                                  jnp.asarray(qpos), softcap=5.0)
    assert relerr(_np(y), r) < TOL["fp32"]


@pytest.mark.parametrize("B,C,KV,n_sm,want", [
    (8, 1024, 8, 132, (6, 176)),      # the LM decode cell: one wave, 384
    (1, 100, 1, 132, (4, 32)),        # a split holds at least min_chunk
    (64, 64, 8, 132, (1, 64)),        # enough (b, kv) pairs already
    (64, 4096, 8, 132, (2, 2048)),    # no split over MAX_CHUNK slots
])
def test_decode_splits_cover_the_cache(B, C, KV, n_sm, want):
    """The mma schedule's split of the rolling cache at llama3.2-1b's heads
    (G 4, D 64, bf16)."""
    nsplit, chunk = tdec.splits(B, C, KV, 4, 64, torch.bfloat16, n_sm)
    assert (nsplit, chunk) == want
    assert chunk % tdec.TILE == 0 and (nsplit - 1) * chunk < C <= \
        nsplit * chunk


@pytest.mark.parametrize("dt", sorted(TOL))
def test_reference_op_sdpa_matches_jax(dt):
    """The reference attention op rounds q·scale, K, V and the
    probabilities to the compute dtype, as JAX's ``_sdpa`` does (the
    kernels and their plain versions stay in fp32); chunked at 512."""
    B, S, H, KV, D = 1, 600, 4, 2, 16
    rng = np.random.RandomState(6)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, B, S, S, H, KV, D, dt)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    plan = types.SimpleNamespace(flow=types.SimpleNamespace(precision=dt))
    jctx = jops_impl.Ctx(mode="prefill", plan=plan)
    tctx = tops_impl.Ctx(mode="prefill", plan=plan)
    jp = jnp.asarray(pos)
    j = jops_impl._sdpa(jctx, jq, jk, jv, jp, jp, causal=True, window=100,
                        softcap=None)
    tp = torch.from_numpy(np.array(pos))
    y = tops_impl._sdpa(tctx, tq, tk, tv, tp, tp, causal=True, window=100,
                        softcap=None)
    assert y.dtype == TDT[dt]
    assert relerr(_np(y), j) < TOL[dt]
