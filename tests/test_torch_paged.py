"""The port's paged-pool kernels' plain versions and the attention op's
paged reference path against the JAX package: its Pallas kernels (run in
interpret mode on the CPU) and ``kernels/ref.py``, on the same numpy
inputs.

The wrappers ``paged_decode_attention`` and ``copy_block`` are called with
CPU tensors, so they run their plain versions (the CUDA kernels themselves
are held against those plain versions on the card, in
``tests/test_torch_gpu.py``).

Only live rows (qpos >= 0) are compared: for a fully masked row the Pallas
kernel and the reference both return a mean of V, which the engine
discards, and the CUDA kernel may stop its walk early.  Tolerances
(``conftest.relerr``: max |diff| over max |ref|):
* fp32 < 1e-5 — the same fp32 arithmetic, summed in another order;
* bf16 < 2e-2 — both compute from the same bf16 inputs; the one bf16
  rounding of the output (and, on the reference path, of q·scale, K, V and
  the probabilities) may land on the other side.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ops_impl as tops_impl
from repro_torch.kernels import decode_attention as tdec

TOL = {"fp32": 1e-5, "bf16": 2e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}

# (B, Sq, H, KV, D, bs, nblk, window, softcap, padded rows): the three
# cases of tests/test_kernels.py (one token a row at heterogeneous lengths),
# then chunked catch-up / verify rows with -1 padding, a window and softcap
PAGED = {
    "gqa": (2, 1, 4, 2, 32, 4, 5, None, None, False),
    "window": (3, 1, 8, 4, 16, 8, 3, 12, None, False),
    "mha_bs16": (1, 1, 4, 1, 64, 16, 2, None, None, False),
    "chunk_padded": (2, 4, 4, 2, 16, 8, 4, None, None, True),
    "verify_window_softcap": (3, 5, 8, 2, 32, 8, 6, 20, 30.0, True),
    "chunk16_bs32": (2, 16, 4, 1, 64, 32, 3, None, 50.0, True),
}


def _case(name, seed=0):
    """numpy inputs of one case: q, pools, a permuted block table, lens
    and qpos (Sq > 1: consecutive positions from lens, the tail of the
    last row padded with -1)."""
    B, Sq, H, KV, D, bs, nblk, win, cap, padded = PAGED[name]
    rng = np.random.RandomState(seed)
    NB = 1 + B * nblk
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    kp = rng.randn(NB, bs, KV, D).astype(np.float32)
    vp = rng.randn(NB, bs, KV, D).astype(np.float32)
    bt = (1 + rng.permutation(B * nblk).reshape(B, nblk)).astype(np.int32)
    cap_tok = nblk * bs - Sq
    lens = np.asarray([(7 * (b + 1)) % cap_tok for b in range(B)], np.int32)
    qpos = (lens[:, None] + np.arange(Sq, dtype=np.int32)[None]).astype(
        np.int32)
    if padded:
        qpos[-1, Sq // 2:] = -1
    return (q, kp, vp, bt, lens, qpos), dict(window=win, softcap=cap), Sq


def _live(y, qpos):
    return np.asarray(y, np.float32)[qpos >= 0]


def _j(a, dt):
    return jnp.asarray(a, jnp.float32).astype(JDT[dt]) \
        if a.dtype == np.float32 else jnp.asarray(a)


def _t(a, dt):
    return torch.from_numpy(a).to(TDT[dt]) if a.dtype == np.float32 \
        else torch.from_numpy(a)


def _tn(y):
    return y.float().numpy()


@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_plain_matches_pallas_interpret(name, dt):
    (q, kp, vp, bt, lens, qpos), kw, Sq = _case(name)
    jqp = jnp.asarray(qpos) if Sq > 1 else None
    tqp = torch.from_numpy(qpos) if Sq > 1 else None
    y = tdec.paged_decode_attention(_t(q, dt), _t(kp, dt), _t(vp, dt),
                                    _t(bt, dt), _t(lens, dt), qpos=tqp, **kw)
    assert y.dtype == TDT[dt] and tuple(y.shape) == q.shape
    pal = jops.paged_decode_attention(_j(q, dt), _j(kp, dt), _j(vp, dt),
                                      _j(bt, dt), _j(lens, dt), qpos=jqp,
                                      interpret=True, **kw)
    assert relerr(_live(_tn(y), qpos), _live(pal, qpos)) < TOL[dt]


@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_plain_matches_ref_fp32(name):
    (q, kp, vp, bt, lens, qpos), kw, Sq = _case(name, seed=1)
    y = tdec.paged_decode_attention_plain(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, lens)),
        qpos=torch.from_numpy(qpos) if Sq > 1 else None, **kw)
    r = jref.paged_decode_attention_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, lens)),
        qpos=jnp.asarray(qpos) if Sq > 1 else None,
        compute_dtype=jnp.float32, **kw)
    assert relerr(_live(_tn(y), qpos), _live(r, qpos)) < TOL["fp32"]


@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("name", ["gqa", "verify_window_softcap",
                                  "chunk16_bs32"])
def test_op_reference_path_matches_jax_ref(name, dt):
    """The attention op's reference path over the pool rounds to the
    compute dtype where the JAX ``paged_decode_attention_ref`` does."""
    (q, kp, vp, bt, lens, qpos), kw, Sq = _case(name, seed=2)
    plan = types.SimpleNamespace(flow=types.SimpleNamespace(precision=dt))
    ctx = tops_impl.Ctx(mode="decode", plan=plan)
    y = tops_impl._paged_sdpa(ctx, _t(q, dt), _t(kp, dt), _t(vp, dt),
                              torch.from_numpy(bt), torch.from_numpy(qpos),
                              **kw)
    r = jref.paged_decode_attention_ref(
        _j(q, dt), _j(kp, dt), _j(vp, dt), jnp.asarray(bt),
        jnp.asarray(lens), qpos=jnp.asarray(qpos), compute_dtype=JDT[dt],
        **kw)
    assert y.dtype == TDT[dt]
    assert relerr(_live(_tn(y), qpos), _live(r, qpos)) < TOL[dt]


def _paged_state(name, seed):
    (q, kp, vp, bt, lens, qpos), kw, Sq = _case(name, seed)
    st = {"kp": torch.from_numpy(kp.copy()), "vp": torch.from_numpy(vp.copy()),
          "bt": torch.from_numpy(bt.copy()),
          "len": torch.from_numpy(lens.copy())}
    return (q, kp, vp, bt, lens, qpos), kw, Sq, st


@pytest.mark.parametrize("name", ["gqa", "chunk_padded"])
def test_paged_op_writes_in_place_then_attends(name):
    """The op writes the new K/V at each row's positions (Sq = 1: at
    ``len``; padding rows into trash block 0), bumps ``len`` in place by
    the live tokens, returns the state dict it was given, and attends over
    the updated pool as the JAX reference does."""
    (q, kp, vp, bt, lens, qpos), kw, Sq, st = _paged_state(name, 3)
    B, _, H, D = q.shape
    KV, bs, nblk = kp.shape[2], kp.shape[1], bt.shape[1]
    rng = np.random.RandomState(4)
    k = rng.randn(B, Sq, KV, D).astype(np.float32)
    v = rng.randn(B, Sq, KV, D).astype(np.float32)
    plan = types.SimpleNamespace(
        flow=types.SimpleNamespace(precision="fp32", kernel_backend="auto"),
        kernels={"paged_decode_attention": "ref"}, platform="cpu")
    op = types.SimpleNamespace(attrs={"state_key": "kv0"})
    ctx = tops_impl.Ctx(mode="decode", plan=plan, state_in={"kv0": st})
    kp_t, len_t = st["kp"], st["len"]
    y = tops_impl.op_attention(ctx, op, {}, torch.from_numpy(q),
                               torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(qpos))
    assert ctx.state_out["kv0"] is st and st["kp"] is kp_t \
        and st["len"] is len_t
    want_kp, want_vp = kp.copy(), vp.copy()
    pos = qpos if Sq > 1 else lens[:, None]
    for b in range(B):
        for c in range(Sq):
            if pos[b, c] < 0:
                continue
            blk = bt[b, (pos[b, c] // bs) % nblk]
            want_kp[blk, pos[b, c] % bs] = k[b, c]
            want_vp[blk, pos[b, c] % bs] = v[b, c]
    mask = np.ones(kp.shape[0], bool)
    mask[0] = False                     # trash block: garbage by contract
    np.testing.assert_array_equal(st["kp"].numpy()[mask], want_kp[mask])
    np.testing.assert_array_equal(st["vp"].numpy()[mask], want_vp[mask])
    np.testing.assert_array_equal(
        st["len"].numpy(), lens + (1 if Sq == 1 else (qpos >= 0).sum(1)))
    r = jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(want_kp), jnp.asarray(want_vp),
        jnp.asarray(bt), jnp.asarray(lens), qpos=jnp.asarray(pos),
        compute_dtype=jnp.float32, **kw)
    assert relerr(_live(_tn(y), pos), _live(r, pos)) < TOL["fp32"]


@pytest.mark.parametrize("lead", [None, 3])
def test_copy_block_plain_matches_jax_exactly(lead):
    """The COW fork, flat and folded: the wrapper on a CPU tensor (the
    plain version) against the Pallas kernel in interpret mode and the
    reference — only block dst changes, byte for byte, in place."""
    NB, bs, KV, D = 6, 4, 2, 16
    shape = (NB, bs, KV, D) if lead is None else (lead, NB, bs, KV, D)
    pool = np.random.RandomState(5).randn(*shape).astype(np.float32)
    src, dst = 2, 5
    t = torch.from_numpy(pool.copy())
    out = tdec.copy_block(t, src, dst)
    assert out is t
    pal = jops.copy_block(jnp.asarray(pool), src, dst, interpret=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(pal))
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jref.copy_block_ref(jnp.asarray(pool), src,
                                                  dst)))


def test_copy_block_bf16_and_bounds():
    pool = torch.randn(2, 4, 3, 1, 8).to(torch.bfloat16)
    before = pool.clone()
    tdec.copy_block(pool, 1, 3)
    assert torch.equal(pool[:, 3], before[:, 1])
    assert torch.equal(pool[:, :3], before[:, :3])
    with pytest.raises(ValueError, match="outside"):
        tdec.copy_block(pool, 0, 4)
    with pytest.raises(ValueError, match="not"):
        tdec.copy_block(pool[0, 0], 0, 1)


def test_paged_wrapper_checks_its_operands():
    (q, kp, vp, bt, lens, qpos), _, _ = _case("chunk_padded")
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, lens)]
    with pytest.raises(ValueError, match="needs qpos"):
        tdec.paged_decode_attention(*args)
    with pytest.raises(ValueError, match="qpos"):
        tdec.paged_decode_attention(*args, qpos=torch.from_numpy(qpos[:, :2]))
    with pytest.raises(ValueError, match="do not form"):
        tdec.paged_decode_attention(args[0], args[1][..., :8], *args[2:],
                                    qpos=torch.from_numpy(qpos))


@pytest.mark.parametrize("B,KV,n_rt,cap,want", [
    (8, 8, 1, 1024, 6),       # the serving decode tick: one wave, 384 blocks
    (8, 8, 1, 64, 2),         # a split holds at least min_chunk tokens
    (1, 1, 1, 4096, 29),      # and at least sqrt(capacity x _cfac)
    (64, 8, 2, 1024, 1),      # enough (row, head, row-tile) blocks already
])
def test_paged_splits(B, KV, n_rt, cap, want):
    """The mma schedule's most splits at llama3.2-1b's heads (G 4, D 64,
    bf16, blocks of 16): one row tile is a decode tick (4 query rows), two
    a five-query verify row (20)."""
    R = 4 if n_rt == 1 else 20
    assert tdec.paged_splits(B, KV, R, cap // 16, 16, 64, torch.bfloat16,
                             132) == want
