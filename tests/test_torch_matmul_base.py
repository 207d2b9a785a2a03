"""matmul_fused's base variant on the CW cores, on the CPU: its routes, its
slab-aligned K split and its ordered, rounded reduction.

The base variant (``vmem_accum=False``, the Pallas kernel's base branch)
sums each ``bk``-deep K slab's fp32 product, rounds it to the output dtype
and adds it into the running sum in that dtype.  On the card it runs on the
CW schedules' cores (``matmul_fused._base_plan``): ``wgmma`` folds each slab
in registers, the split-K cores cut their K split at the slabs
(``_base_split``) and ``rt::splitk_reduce_slabs`` walks the fp32 partials in
K order, summing a slab's in fp32 and rounding between slabs.
:func:`reduce_model` does exactly that on the CPU, split by split, and is
held to the JAX package's Pallas kernel in interpret mode on the same numpy
inputs: fp32 within relerr 1e-5 (the same sums in another order); a bf16
output element within one bf16 ulp of the largest slab sum or running sum
it passed through.  Both round each slab's fp32 sum and each running sum to
nearest even, but the fp32 sums of a slab are taken in another order (split
by split here, in one dot there), so a slab sum a hair from a tie may round
the other way: one ulp at the slab's magnitude, which after later slabs
cancel may be two or more ulps of a smaller result.  The kernels run only
on the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.kernels import ops
from repro_torch.kernels import matmul_fused as tmm

BF, F32 = torch.bfloat16, torch.float32
SMS = 132
TILE = (256, 512, 256)                 # the default tile: 512-deep slabs


def reduce_model(x, w, bias, act, tile, odt, sms=SMS):
    """The base variant as the CW cores compute it: fp32 partials of the
    plan's splits, each slab's splits summed in K order in fp32, the slab
    rounded to ``odt`` and added into the ``odt`` running sum, then bias
    and act on the widened sum.  x (M, K), w (K, N) torch tensors on the
    CPU.  Returns the output and, per element, the largest magnitude a
    rounding step saw (slab sums and running sums)."""
    from repro_torch.core.ops_impl import _act
    M, K = x.shape
    N = w.shape[1]
    bk = tmm._slab_depth(K, tile)
    _, nsplit, kc = tmm._base_plan(M, K, N, x.dtype, odt, True, bk, sms)
    per_slab = max(1, bk // kc)
    xf, wf = x.float(), w.float()
    total = torch.zeros(M, N, dtype=odt)
    part = torch.zeros(M, N)
    seen = torch.zeros(M, N)
    for s in range(nsplit):
        part = part + xf[:, s * kc:(s + 1) * kc] @ wf[s * kc:(s + 1) * kc]
        if (s + 1) % per_slab == 0 or s == nsplit - 1:
            total = (total.float() + part.to(odt).float()).to(odt)
            seen = torch.maximum(seen, torch.maximum(part.abs(),
                                                     total.float().abs()))
            part = torch.zeros(M, N)
    y = total.float()
    if bias is not None:
        y = y + bias.float()
    if act:
        y = _act(y, act)
    return y.to(odt), seen


def _ulps(y, ref, scale=None):
    """|y - ref| in bf16 ulps of ``scale`` (default: of ref)."""
    ref = np.asarray(ref, np.float32)
    mag = np.abs(ref) if scale is None else np.maximum(np.abs(ref), scale)
    e = np.floor(np.log2(np.maximum(mag, 2.0 ** -126)))
    return np.abs(np.asarray(y, np.float32) - ref) / 2.0 ** (e - 7)


# name -> (M, K, N, tile, in dtype, bias, act): the route each takes and
# why.  small_m / ffma_small_m at 8-24 rows: one slab in 16 splits (finer
# than a slab), four 128-deep slabs in 4 splits each, a K tail (200 in
# 64-deep slabs: the last 8 deep); ffma above 64 rows (a grid of one block:
# K split in 64-deep stages, two a slab); wgmma above 64 rows in bf16 (one
# fold a slab, a 40-deep tail)
MODEL_CASES = {
    "one_slab_16_splits": (8, 512, 96, TILE, BF, True, None),
    "four_slabs_fine": (8, 512, 48, (8, 128, 32), BF, False, "relu"),
    "k_tail": (16, 200, 40, (16, 64, 32), BF, True, "relu"),
    "fp32_small_m_slabs": (8, 384, 40, (8, 128, 8), F32, True, None),
    "ffma_two_splits_a_slab": (96, 384, 40, (8, 128, 8), F32, False, "relu"),
    "wgmma_slabs_tail": (96, 1000, 72, (32, 64, 32), BF, True, None),
}
WANT_ROUTE = {"one_slab_16_splits": ("small_m", 16, 32),
              "four_slabs_fine": ("small_m", 16, 32),
              "k_tail": ("small_m", 4, 64),
              "fp32_small_m_slabs": ("ffma_small_m", 12, 32),
              "ffma_two_splits_a_slab": ("ffma", 6, 64),
              "wgmma_slabs_tail": ("wgmma", 16, 64)}


@pytest.mark.parametrize("odt", ["same", "bf16"])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_reduce_model_matches_pallas(name, odt):
    M, K, N, tile, dt, has_bias, act = MODEL_CASES[name]
    out_dt = dt if odt == "same" else BF
    rng = np.random.RandomState(K + N)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * K ** -0.5).astype(np.float32)
    b = rng.randn(N).astype(np.float32) if has_bias else None
    tx, tw = torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt)
    tb = torch.from_numpy(b) if has_bias else None
    jdt = jnp.bfloat16 if dt == BF else jnp.float32
    jx, jw = jnp.asarray(tx.float().numpy(), jdt), jnp.asarray(
        tw.float().numpy(), jdt)
    jb = jnp.asarray(b) if has_bias else None
    got, seen = reduce_model(tx, tw, tb, act, tile, out_dt)
    got, seen = got.float().numpy(), seen.numpy()
    pal = ops.matmul_fused(jx, jw, bias=jb, act=act, tile=tile,
                           vmem_accum=False, interpret=True,
                           out_dtype=jnp.bfloat16 if out_dt == BF else None)
    pal = np.asarray(pal.astype(jnp.float32))
    plain = tmm.matmul_fused_plain(tx, tw, bias=tb, act=act, tile=tile,
                                   out_dtype=out_dt, vmem_accum=False)
    plain = plain.float().numpy()
    if out_dt == F32:
        assert relerr(got, pal) < 1e-5 and relerr(got, plain) < 1e-5
    else:
        assert _ulps(got, pal, seen).max() <= 1.0
        assert _ulps(got, plain, seen).max() <= 1.0


@pytest.mark.parametrize("name", sorted(WANT_ROUTE))
def test_route_and_split_of_the_model_cases(name):
    M, K, N, tile, dt, _, _ = MODEL_CASES[name]
    bk = tmm._slab_depth(K, tile)
    assert tmm._base_plan(M, K, N, dt, dt, True, bk) == WANT_ROUTE[name]


# (M, K, N, in dtype, out dtype) -> (schedule, nsplit, kc) at the base
# variant's timed shapes, tile (256, 512, 256): the ResNet-34 FC (one
# 512-deep slab, split in 16 on small_m / ffma_small_m as the CW form is)
# and the 4096 x 2048 x 2048 projection (four slabs: wgmma folds each in
# registers; fp32 ffma's grid of 512 blocks stays unsplit in fp32 out and
# takes one split a slab in bf16 out)
PLANS = [
    ((8, 512, 1000, BF, BF), ("small_m", 16, 32)),
    ((8, 512, 1000, F32, F32), ("ffma_small_m", 16, 32)),
    ((4096, 2048, 2048, BF, BF), ("wgmma", 4, 512)),
    ((4096, 2048, 2048, BF, F32), ("wgmma", 4, 512)),
    ((4096, 2048, 2048, F32, F32), ("ffma", 1, 2048)),
    ((4096, 2048, 2048, F32, BF), ("ffma", 4, 512)),
]


@pytest.mark.parametrize("args,want", PLANS, ids=[str(a) for a, _ in PLANS])
def test_plan_at_the_timed_shapes(args, want):
    M, K, N, dt, odt = args
    assert tmm._base_plan(M, K, N, dt, odt, True,
                          tmm._slab_depth(K, TILE)) == want


# shapes and tiles around the routes: K or N off the 8 (bf16) / 4 (fp32)
# grid, unaligned, a slab off the core's stage (40-deep) -> simt
SCHED = [
    ((8, 512, 1000, BF, True, 512), "small_m"),
    ((65, 512, 1000, BF, True, 512), "wgmma"),
    ((64, 512, 1000, F32, True, 512), "ffma_small_m"),
    ((100, 512, 1000, F32, True, 512), "ffma"),
    ((8, 120, 84, BF, True, 128), "simt"),
    ((8, 84, 10, F32, True, 128), "simt"),
    ((8, 512, 1000, BF, False, 512), "simt"),
    ((3, 200, 40, BF, True, 40), "simt"),
    ((100, 200, 40, F32, True, 40), "simt"),
    ((100, 200, 40, BF, True, 96), "simt"),
    ((100, 200, 40, F32, True, 96), "simt"),
    ((8, 200, 40, BF, True, 96), "small_m"),
]


@pytest.mark.parametrize("args,want", SCHED, ids=[str(a) for a, _ in SCHED])
def test_base_schedule(args, want):
    assert tmm._base_schedule(*args) == want


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("stage", [32, 64])
def test_base_split_never_mixes_two_slabs(stage, exact):
    """Over CW splits and slab depths: every split lies inside one slab
    (kc divides bk, a multiple of the stage), covers K with no empty split,
    and is no coarser than the CW split; an unsplit CW grid in fp32 out
    stays as it is."""
    for K in (64, 200, 512, 1000, 2048, 8192):
        for bk in (stage, 128, 256, 512):
            for nsplit in (1, 2, 3, 5, 16, 40):
                kc = (-(-K // nsplit) + stage - 1) // stage * stage
                cw = (-(-K // kc), kc)
                got = tmm._base_split(cw, K, bk, stage, exact)
                if cw[0] == 1 and not exact:
                    assert got == cw
                    continue
                n, kcb = got
                assert bk % kcb == 0 and kcb % stage == 0
                assert kcb <= max(cw[1], stage) or kcb == bk
                assert (n - 1) * kcb < K <= n * kcb
                for s in range(n):
                    lo, hi = s * kcb, min(K, (s + 1) * kcb) - 1
                    assert lo // bk == hi // bk
