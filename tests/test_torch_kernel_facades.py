"""The kernel facades ``repro_torch.kernels.ref`` and ``repro_torch.kernels.ops``
against the JAX package's ``repro.kernels.ref``: every oracle on the same
seeded numpy inputs, fp32 within 1e-5 and bf16 within ``_tol`` (the
tolerances of ``tests/test_kernels.py``).  ``paged_decode_attention_ref``
is held to JAX's ref, which rounds to ``compute_dtype``, not to the Pallas
kernel (ROADMAP Queue 3).  On the CPU each ``ops.*`` wrapper runs its
plain version, so it is held to the same oracle; the base variant
(``vmem_accum=False``) to JAX's facade in Pallas interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bf16" else 1e-5


def _relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-9)


def _inputs(case, rng):
    """(args, kwargs) of numpy arrays (floats) or ints for one case."""
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    if case.startswith("matmul"):
        kw = {"glu": dict(w2=f(48, 40), act="silu"),
              "bias_act": dict(bias=f(40), act="gelu")}.get(
                  case.split("-")[1] if "-" in case else "", {})
        return (f(2, 6, 48), f(48, 40)), kw
    if case.startswith("flash"):
        q, k, v = f(2, 24, 4, 16), f(2, 24, 2, 16), f(2, 24, 2, 16)
        kw = {"causal": dict(), "window": dict(window=7, softcap=20.0),
              "full": dict(causal=False),
              "offset": dict(q_offset=5)}.get(case.split("-")[1], {})
        if case.endswith("positions"):
            pos = np.tile(np.arange(24, dtype=np.int32) - 3, (2, 1))
            pos[1] += 3
            kw = dict(positions=pos)
        if case.endswith("offset"):
            q = f(2, 8, 4, 16)
        return (q, k, v), kw
    if case == "decode":
        pos = np.tile(np.arange(32, dtype=np.int32), (3, 1))
        pos[:, 20:] = -1
        return (f(3, 1, 4, 16), f(3, 32, 2, 16), f(3, 32, 2, 16), pos,
                np.array([[19], [12], [5]], np.int32)), dict(window=9)
    if case.startswith("paged"):
        Sq = 3 if case.endswith("chunk") else 1
        bt = rng.permutation(np.arange(1, 13)).reshape(3, 4).astype(np.int32)
        lens = np.array([9, 30, 17], np.int32)
        kw = dict(softcap=15.0)
        if Sq > 1:
            qp = lens[:, None] - Sq + np.arange(Sq, dtype=np.int32)
            qp[0, 0] = -1
            kw["qpos"] = qp
        return (f(3, Sq, 4, 16), f(13, 8, 2, 16), f(13, 8, 2, 16), bt,
                lens), kw
    if case == "copy_block":
        return (f(2, 6, 4, 2, 8), 3, 5), {}
    if case == "conv2d":
        bn = (f(8) * 0.1 + 1, f(8) * 0.1, f(8) * 0.1,
              np.abs(f(8)) + 0.5)
        return (f(2, 9, 9, 4), f(3, 3, 4, 8)), dict(stride=2, bn=bn,
                                                    act="relu")
    raise KeyError(case)


def _to(x, mod, dt):
    if not isinstance(x, np.ndarray):
        return x
    if x.dtype != np.float32:
        return jnp.asarray(x) if mod == "jax" else torch.from_numpy(x)
    return jnp.asarray(x, dt[1]) if mod == "jax" else \
        torch.from_numpy(x).to(dt[2])


def _conv(tree, mod, dt):
    if isinstance(tree, dict):
        return {k: _conv(v, mod, dt) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_conv(v, mod, dt) for v in tree)
    return _to(tree, mod, dt)


CASES = ("matmul", "matmul-glu", "matmul-bias_act", "flash-causal",
         "flash-window", "flash-full", "flash-offset", "flash-positions",
         "decode", "paged", "paged-chunk", "copy_block", "conv2d")
NAMES = {"matmul": "matmul_fused", "flash": "flash_attention",
         "decode": "decode_attention", "paged": "paged_decode_attention",
         "copy_block": "copy_block", "conv2d": "conv2d_fused"}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_ref_and_ops_match_jax_ref(case, dt):
    name = NAMES[case.split("-")[0]]
    args, kw = _inputs(case, np.random.RandomState(CASES.index(case)))
    d = DTYPES[dt]
    # one jit of JAX's oracle (its ops compile once, not one by one)
    arrays = {k: v for k, v in kw.items() if isinstance(v, (np.ndarray,
                                                            tuple))}
    static = {k: v for k, v in kw.items() if k not in arrays}
    jargs = _conv(args, "jax", d)
    dyn = [i for i, a in enumerate(jargs) if not isinstance(a, int)]

    def oracle(arr, kws):
        full = list(jargs)
        for i, a in zip(dyn, arr):
            full[i] = a
        return getattr(jref, name + "_ref")(*full, **kws, **static)
    want = jax.jit(oracle)([jargs[i] for i in dyn], _conv(arrays, "jax", d))
    got = getattr(tref, name + "_ref")(*_conv(args, "torch", d),
                                       **_conv(kw, "torch", d))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert _relerr(got.float().numpy(), want) < _tol(dt), case
    tkw = dict(_conv(kw, "torch", d))
    targs = list(_conv(args, "torch", d))
    if name == "copy_block":            # the wrapper writes in place
        targs[0] = targs[0].clone()
    via_ops = getattr(tops, name)(*targs, **tkw)
    if name == "paged_decode_attention" and dt == "bf16":
        # the wrapper's plain version stays in fp32 (as the kernels do);
        # JAX's oracle rounds to bf16: held to it within bf16 tolerance
        assert _relerr(via_ops.float().numpy(), want) < _tol(dt), case
    else:
        assert torch.equal(via_ops, got) or \
            _relerr(via_ops.float().numpy(), got.float().numpy()) < 1e-6


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_base_variant_matches_jax_facade(dt):
    """``ops.matmul_fused(vmem_accum=False)``: the paper's base kernel, each
    K slab rounded to the output dtype, against JAX's facade in Pallas
    interpret mode (K 640 over slabs of 256: three slabs, one padded)."""
    d = DTYPES[dt]
    rng = np.random.RandomState(7)
    x, w = rng.randn(16, 640).astype(np.float32), \
        rng.randn(640, 128).astype(np.float32)
    want = jops.matmul_fused(jnp.asarray(x, d[1]), jnp.asarray(w, d[1]),
                             vmem_accum=False, interpret=True)
    got = tops.matmul_fused(torch.from_numpy(x).to(d[2]),
                            torch.from_numpy(w).to(d[2]), vmem_accum=False)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert _relerr(got.float().numpy(), want) < _tol(dt)
