"""lru_scan's chunked schedule on the CPU: a model of its arithmetic and its
launch geometry.

The chunked kernel (``csrc/lru_scan.cu`` ``lru_scan_chunked``) runs only on
the card.  Here :func:`chunked_model` walks the windows, the warps' chunks
and the carries in the kernel's own order and with its own fp32 operations
(an FMA a step, rounded once), at the window that
``lru_scan.scan_geometry`` gives the shape, and is held against the JAX
package's Pallas ``lru_scan`` in interpret mode and its ``lru_scan_ref``
on the same numpy inputs: fp32 within 1e-5, bf16 within 2e-2
(``tests/test_kernels.py``'s ``_tol``).  The geometry is pinned at the
hybrid's three path shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.kernels.lru_scan import lru_scan as jlru_scan
from repro.kernels.lru_scan import lru_scan_ref as jlru_scan_ref
from repro_torch.kernels import lru_scan as kl

TOL = {"fp32": 1e-5, "bf16": 2e-2}


def _fma(a, h, b):
    """fp32 fmaf: the product exact in float64, one rounding to fp32."""
    return (a.astype(np.float64) * h + b).astype(np.float32)


def chunked_model(a: np.ndarray, b: np.ndarray, steps: int) -> np.ndarray:
    """The chunked kernel's arithmetic on fp32 (B, S, W) inputs: windows of
    ``steps`` rows; in each, warp c's chunk of 8 rows scanned from zero to
    (P_c, H_c); the carry folded through the chunks in order, each chunk
    taking the fold before it as its carry-in; the chunk rescanned from
    it.  Rows past S read zeros, as the kernel's zero-filled loads do."""
    B, S, W = a.shape
    L = kl.STEPS_A_WARP
    C = steps // L
    nwin = -(-S // steps)
    pad = nwin * steps - S
    ap = np.concatenate([a, np.zeros((B, pad, W), np.float32)], axis=1)
    bp = np.concatenate([b, np.zeros((B, pad, W), np.float32)], axis=1)
    h = np.zeros_like(ap)
    carry = np.zeros((B, W), np.float32)
    for win in range(nwin):
        P = np.ones((C, B, W), np.float32)
        H = np.zeros((C, B, W), np.float32)
        for c in range(C):
            for j in range(L):
                t = win * steps + c * L + j
                H[c] = _fma(ap[:, t], H[c], bp[:, t])
                P[c] = P[c] * ap[:, t]
        cin = []
        for c in range(C):
            cin.append(carry)
            carry = _fma(P[c], carry, H[c])
        for c in range(C):
            hc = cin[c]
            for j in range(L):
                t = win * steps + c * L + j
                hc = _fma(ap[:, t], hc, bp[:, t])
                h[:, t] = hc
    return h[:, :S]


def _inputs(B, S, W, seed=3):
    rng = np.random.RandomState(seed)
    return ((rng.rand(B, S, W) * 0.9 + 0.05).astype(np.float32),
            rng.randn(B, S, W).astype(np.float32))


# (B, S, W): S = 1; S shorter than a warp's chunk of 8; S not a multiple of
# the window (32) nor of the chunk; B = 1; W not a multiple of the 32-channel
# strip; and a (1, 2080, 64) cut of the window run's (1, 2080, 2560)
CASES = {"s1": (2, 1, 32), "s5_under_a_chunk": (2, 5, 64),
         "s37_ragged": (3, 37, 48), "b1_s100": (1, 100, 40),
         "w40_partial_strip": (2, 70, 40), "window_cut": (1, 2080, 64)}


def _steps(B, S, W, elem):
    return kl.scan_geometry(B, S, W, elem)[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_model_matches_jax_kernel_and_ref_fp32(name):
    B, S, W = CASES[name]
    a, b = _inputs(B, S, W)
    got = chunked_model(a, b, _steps(B, S, W, 4))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert relerr(got, jlru_scan(ja, jb, block_w=128, interpret=True)) < \
        TOL["fp32"]
    assert relerr(got, jlru_scan_ref(ja, jb)) < TOL["fp32"]
    # and the port's plain version, which the kernel is held to on the card
    assert relerr(got, kl.lru_scan_plain(torch.from_numpy(a),
                                         torch.from_numpy(b)).numpy()) \
        < TOL["fp32"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_model_matches_jax_ref_bf16(name):
    """bf16 operands (a and b rounded to bf16, the state fp32, h rounded to
    bf16 once) at the bf16 window."""
    B, S, W = CASES[name]
    a, b = _inputs(B, S, W, seed=5)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    a16, b16 = np.asarray(ja, np.float32), np.asarray(jb, np.float32)
    got = chunked_model(a16, b16, _steps(B, S, W, 2))
    got = np.asarray(jnp.asarray(got, jnp.bfloat16), np.float32)
    assert relerr(got, jlru_scan_ref(ja, jb)) < TOL["bf16"]


def test_chunked_model_windows_carry_exactly():
    """With a = 1 and b = 1 every h_t is t + 1, exactly, whatever the
    window: the carries hand each window and chunk its exact start."""
    a = np.ones((1, 300, 32), np.float32)
    for steps in kl.WINDOW_STEPS:
        h = chunked_model(a, a, steps)
        np.testing.assert_array_equal(
            h[0, :, 0], np.arange(1, 301, dtype=np.float32))


# the hybrid's lru_scan shapes (fp32, as op_rg_lru hands them): the 8 x 512
# prefill (generate), the window run's one row of 2080, and workload R's
# prefill batches of 256-token prompts (8 rows, then refills of 1); the
# bf16 (8, 512, 2560) kernel case
GEOMETRY = {(8, 512, 2560, 4): (32, 4, 640), (1, 2080, 2560, 4): (128, 16, 80),
            (8, 256, 2560, 4): (32, 4, 640), (1, 256, 2560, 4): (128, 16, 80),
            (8, 512, 2560, 2): (32, 4, 320)}


@pytest.mark.parametrize("shape", sorted(GEOMETRY), ids=str)
def test_scan_geometry_at_the_path_shapes(shape):
    steps, warps, blocks = kl.scan_geometry(*shape)
    assert (steps, warps, blocks) == GEOMETRY[shape]
    B, S, W, elem = shape
    assert warps * kl.STEPS_A_WARP == steps
    assert blocks == B * W * elem // kl.ROW_BYTES
    per_sm = -(-blocks // 132)
    inflight = per_sm * (kl.NSTAGE - 1) * steps * 2 * kl.ROW_BYTES
    # 48 KB of loads in flight an SM, or the largest window
    assert inflight >= kl.INFLIGHT_BYTES or steps == kl.WINDOW_STEPS[-1]


def test_scan_geometry_fills_the_card_at_one_row():
    """The window run's one row: 80 blocks of 16 warps, one wave (every
    block resident at once), two 32 KB windows of a and b in flight on
    each of the 80 SMs it occupies."""
    steps, warps, blocks = kl.scan_geometry(1, 2080, 2560, 4)
    assert blocks <= 132 and warps == 16
    assert (kl.NSTAGE - 1) * steps * 2 * kl.ROW_BYTES == 64 * 1024


def test_scan_geometry_no_window_past_the_sequence():
    assert kl.scan_geometry(1, 1, 64, 4)[0] == 32
    assert kl.scan_geometry(1, 40, 64, 4)[0] == 64
    assert kl.scan_geometry(1, 10 ** 5, 64, 4)[0] == 128


@pytest.mark.parametrize("W,elem,aligned,want", [
    (2560, 4, True, "chunked"), (2560, 2, True, "chunked"),
    (4, 4, True, "chunked"), (8, 2, True, "chunked"),
    (130, 4, True, "seq"), (100, 2, True, "seq"), (2560, 4, False, "seq")])
def test_schedule_rule(W, elem, aligned, want):
    assert kl._schedule(W, elem, aligned) == want


def test_cpu_wrapper_counts_no_schedule_or_shape():
    a, b = _inputs(2, 9, 40)
    before = (kl.lru_scan.launches, dict(kl.lru_scan.schedules),
              dict(kl.lru_scan.shapes))
    got = kl.lru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(got, kl.lru_scan_plain(torch.from_numpy(a),
                                              torch.from_numpy(b)))
    assert (kl.lru_scan.launches, kl.lru_scan.schedules,
            kl.lru_scan.shapes) == before
    assert set(kl.lru_scan.schedules) == set(kl.SCHEDULES)
