"""matmul_fused's base variant and its schedule choice on the CPU.

The base variant (``vmem_accum=False``) is held against the JAX package's
Pallas kernel in interpret mode on the same numpy inputs: fp32 within
relerr 1e-5 (the same sums in another order), bf16 within one bf16 ulp of
each element (both round each slab's fp32 product and each running sum to
nearest even, and the fp32 sums inside a slab may differ in their last
bits); after gelu or silu, whose torch and XLA forms differ in the last
bits of values near 0, an element may instead lie within 1e-5 of JAX's.
Where there are several slabs the CW result fails that check.
``_schedule`` and ``_split_k`` are pure functions of the shape; the
schedules' kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""
import jax  # noqa: F401  (JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.kernels import ops
from repro_torch.kernels import matmul_fused as tmm

R = np.random.RandomState(15)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, name):
    jdt, tdt = DTYPES[name]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(t):
    return t.float().numpy()


def _within_ulp(y, ref, floor=0.0):
    """Each element of y within one bf16 ulp of ref's, or within ``floor``
    of it."""
    y, ref = np.asarray(y, np.float32), np.asarray(ref, np.float32)
    return bool(((_ulps(y, ref) <= 1.0) | (np.abs(y - ref) <= floor)).all())


def _ulps(y, ref):
    """|y - ref| in units of ref's bf16 ulp (2^(e - 7) for ref in
    [2^e, 2^(e+1)); the smallest normal's for ref = 0)."""
    ref = np.asarray(ref, np.float32)
    e = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
    return np.abs(np.asarray(y, np.float32) - ref) / 2.0 ** (e - 7)


# (x's leading shape, K, N, tile, bias, act): the slabs are tile[1] deep,
# cut to rup(K, 128); K = 200 with 64-deep slabs leaves a tail of 8
BASE_CASES = {
    "one_slab": ((16,), 96, 40, (16, 128, 32), False, None),
    "bias_gelu": ((24,), 256, 48, (8, 64, 32), True, "gelu"),
    "k_tail": ((20,), 200, 32, (8, 64, 32), True, "relu"),
    "leading_dims": ((2, 5), 160, 24, (8, 32, 32), False, "silu"),
}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(BASE_CASES))
def test_base_variant_matches_pallas(name, dt):
    lead, K, N, tile, has_bias, act = BASE_CASES[name]
    shape = (*lead, K)
    jx, tx = _both(R.randn(*shape), dt)
    jw, tw = _both(R.randn(K, N), dt)
    jb, tb = _both(R.randn(N), dt) if has_bias else (None, None)
    y = tmm.matmul_fused(tx, tw, bias=tb, act=act, tile=tile,
                         vmem_accum=False)
    assert y.shape == (*shape[:-1], N) and y.dtype == DTYPES[dt][1]
    pal = ops.matmul_fused(jx, jw, bias=jb, act=act, tile=tile,
                           vmem_accum=False, interpret=True)
    if dt == "fp32":
        assert relerr(_np(y), pal) < 1e-5
    else:       # torch's and XLA's gelu / silu differ in the last bits near 0
        floor = 0.0 if act in (None, "relu") else 1e-5
        assert _within_ulp(_np(y), pal, floor)
        if K > tmm._slab_depth(K, tile):        # several slabs: not the CW
            cw = tmm.matmul_fused(tx, tw, bias=tb, act=act, tile=tile)
            assert not _within_ulp(_np(cw), pal, floor)
    assert torch.equal(y, tmm.matmul_fused_plain(
        tx, tw, bias=tb, act=act, tile=tile, vmem_accum=False))


def test_base_variant_bf16_many_slabs_is_not_the_cw_kernel():
    """16 slabs of 64 in bf16: the port's base variant is JAX's within one
    ulp, and the CW result differs from JAX's base by far more."""
    jx, tx = _both(R.randn(16, 1024), "bf16")
    jw, tw = _both(R.randn(1024, 64), "bf16")
    tile = (16, 64, 64)
    pal = np.asarray(ops.matmul_fused(jx, jw, tile=tile, vmem_accum=False,
                                      interpret=True).astype(jnp.float32))
    y = _np(tmm.matmul_fused(tx, tw, tile=tile, vmem_accum=False))
    assert _ulps(y, pal).max() <= 1.0
    cw = _np(tmm.matmul_fused(tx, tw, tile=tile))
    assert relerr(cw, pal) > 1e-3
    assert relerr(cw, pal) > 10 * max(relerr(y, pal), 1e-6)
    assert (_ulps(cw, pal) > 1.0).mean() > 0.05


def test_base_variant_default_tile_is_the_jax_default():
    """tile=None means (256, 512, 256) in both packages: K = 1536 is three
    512-deep slabs."""
    jx, tx = _both(R.randn(8, 1536), "bf16")
    jw, tw = _both(R.randn(1536, 32), "bf16")
    pal = ops.matmul_fused(jx, jw, vmem_accum=False, interpret=True)
    y = tmm.matmul_fused(tx, tw, vmem_accum=False)
    assert _ulps(_np(y), pal).max() <= 1.0
    assert torch.equal(y, tmm.matmul_fused_plain(tx, tw, tile=(256, 512, 256),
                                                 vmem_accum=False))


def test_base_variant_refuses_the_glu_pair():
    x, w = torch.randn(4, 16), torch.randn(16, 8)
    for fn in (tmm.matmul_fused, tmm.matmul_fused_plain):
        with pytest.raises(ValueError, match="does not support the GLU"):
            fn(x, w, w2=w, vmem_accum=False)
    jx, jw = jnp.asarray(x.numpy()), jnp.asarray(w.numpy())
    with pytest.raises(AssertionError, match="does not support the GLU"):
        ops.matmul_fused(jx, jw, w2=jw, vmem_accum=False, interpret=True)


# every CW product on the main paths: (M, K, N, in dtype, glu, aligned) ->
# the schedule.  llama3.2-1b (d 2048, KV 512, d_ff 8192) and
# recurrentgemma-2b (d 2560, KV 256, d_ff 7680) at 8 x 512 prefill rows,
# 8 x 256 serving buckets, 128 (chunked catch-up, 8 x 16), 40 (ngram:4
# verify, 8 x 5: the GLU pair's crossover is 32 rows), 32 and 8 (decode);
# the CNN heads at batch 8
LLAMA = [(2048, 2048, False), (2048, 512, False), (2048, 8192, True),
         (8192, 2048, False)]
HYBRID = [(2560, 2560, False), (2560, 256, False), (2560, 7680, True),
          (7680, 2560, False)]
BF, F32 = torch.bfloat16, torch.float32
SCHEDULE_CASES = (
    [((M, K, N, BF, g, True), "wgmma") for M in (4096, 2048, 128)
     for K, N, g in LLAMA + HYBRID]
    + [((M, K, N, BF, g, True), "small_m") for M in (32, 8, 1)
       for K, N, g in LLAMA + HYBRID]
    + [((40, K, N, BF, g, True), "wgmma" if g else "small_m")
       for K, N, g in LLAMA + HYBRID]
    + [((65, 2048, 2048, BF, False, True), "wgmma"),
       ((64, 2048, 2048, BF, False, True), "small_m"),
       ((33, 2048, 8192, BF, True, True), "wgmma"),
       ((8, 512, 1000, BF, False, True), "small_m"),      # ResNet-34 FC
       ((8, 1024, 1000, BF, False, True), "small_m"),     # MobileNetV1 FC
       ((8, 400, 120, BF, False, True), "small_m"),       # LeNet-5 f5
       ((8, 120, 84, BF, False, True), "simt"),           # LeNet-5 f6
       ((8, 84, 10, BF, False, True), "simt"),            # LeNet-5 out
       ((4096, 2048, 2048, BF, False, False), "simt"),    # unaligned view
       ((4096, 2044, 2048, BF, False, True), "simt"),     # K % 8
       ((8, 2048, 2044, BF, True, True), "simt")]         # N % 8
    # fp32 (the base flow): the same split on the FFMA schedules
    + [((M, K, N, F32, g, True),
        "ffma_small_m" if M <= (32 if g else 64) else "ffma")
       for M in (4096, 40, 8) for K, N, g in LLAMA + HYBRID
       + [(512, 1000, False)]]
    + [((65, 2048, 2048, F32, False, True), "ffma"),
       ((64, 2048, 2048, F32, False, True), "ffma_small_m"),
       ((33, 2048, 8192, F32, True, True), "ffma"),
       ((8, 400, 120, F32, False, True), "ffma_small_m"),    # LeNet-5 f5
       ((8, 120, 84, F32, False, True), "ffma_small_m"),     # LeNet-5 f6
       ((8, 84, 10, F32, False, True), "simt"),              # LeNet-5 out
       ((4096, 2048, 2048, F32, False, False), "simt"),      # unaligned
       ((8, 2048, 512, F32, False, False), "simt"),          # unaligned
       ((4096, 2046, 2048, F32, False, True), "simt"),       # K % 4
       ((8, 2048, 2046, F32, True, True), "simt"),           # N % 4
       ((8, 2050, 512, F32, False, True), "simt")])          # K % 4


@pytest.mark.parametrize("args,want", SCHEDULE_CASES,
                         ids=[f"{a[0]}x{a[1]}x{a[2]}-{str(a[3])[6:]}"
                              f"{'-glu' if a[4] else ''}"
                              f"{'' if a[5] else '-unaligned'}"
                              for a, _ in SCHEDULE_CASES])
def test_schedule_at_every_main_path_shape(args, want):
    assert tmm._schedule(*args) == want


# the small_m and ffma_small_m shapes: llama's and the hybrid's decode
# projections, a verify batch, each form's crossover, a one-stage K, the
# ResNet-34 FC and the fp32 decode shapes with K or N a multiple of 4 only
@pytest.mark.parametrize("M,K,N", [(8, 2048, 2048), (8, 2048, 512),
                                   (8, 8192, 2048), (8, 2560, 7680),
                                   (40, 2048, 2048), (64, 7680, 2560),
                                   (1, 24, 8), (8, 512, 1000),
                                   (8, 2560, 256), (8, 7680, 2560),
                                   (32, 2048, 8192), (8, 120, 84),
                                   (3, 20, 20), (1, 2052, 2048)])
def test_split_k_covers_k_in_32_deep_stages(M, K, N):
    nsplit, kc = tmm._split_k(M, K, N)
    assert kc % tmm.SMALL_M_BK == 0 and nsplit >= 1
    assert (nsplit - 1) * kc < K <= nsplit * kc
    # partials (written and read back) no heavier than the weight read
    assert nsplit == 1 or 8 * nsplit * M * N <= 2 * K * N


def test_cpu_wrappers_count_nothing():
    """On CPU tensors every form runs its plain version and no counter
    moves: the CW total, the per-schedule split, the base variant's."""
    before = (tmm.matmul_fused.launches,
              dict(tmm.matmul_fused.schedule_launches),
              tmm.matmul_fused.base_launches,
              dict(tmm.matmul_fused.base_schedule_launches))
    x, w, b = torch.randn(5, 64), torch.randn(64, 16), torch.randn(16)
    xb, wb = x.bfloat16(), w.bfloat16()
    assert torch.equal(tmm.matmul_fused(xb, wb, w2=wb),
                       tmm.matmul_fused_plain(xb, wb, w2=wb))
    assert torch.equal(tmm.matmul_fused(x, w, bias=b, act="relu"),
                       tmm.matmul_fused_plain(x, w, bias=b, act="relu"))
    assert torch.equal(
        tmm.matmul_fused(xb, wb, bias=b, vmem_accum=False, tile=(8, 32, 8)),
        tmm.matmul_fused_plain(xb, wb, bias=b, vmem_accum=False,
                               tile=(8, 32, 8)))
    assert (tmm.matmul_fused.launches,
            tmm.matmul_fused.schedule_launches,
            tmm.matmul_fused.base_launches,
            tmm.matmul_fused.base_schedule_launches) == before
    assert set(tmm.matmul_fused.schedule_launches) == set(tmm.SCHEDULES)
    assert set(tmm.matmul_fused.base_schedule_launches) == set(tmm.SCHEDULES)
