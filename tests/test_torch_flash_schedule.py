"""The ffma flash kernel's tiles and block order on the CPU, and copy_block
on a (K, V) pair of pools.

``_ffma_smem_bytes`` and ``_ffma_blocks`` are pure functions of the shapes
(``csrc/flash_attention_ffma.cu`` static_asserts the same shared bytes, and
``test_flash_attention_ffma_tiles`` in ``tests/test_torch_gpu.py`` holds the
table to the kernel's on the card; ``test_flash_schedule`` in
``tests/test_torch_attention.py`` pins ``_schedule`` at every dtype and
head width).
copy_block's wrapper on CPU tensors runs its plain version pool by pool; it
is held byte for byte against the JAX package's Pallas kernel in interpret
mode, and the serving cache's fork hands a paged entry's two pools to it in
one call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import attention as tatt
from repro_torch.kernels import decode_attention as tdec

BF, F32 = torch.bfloat16, torch.float32
SMEM_OPT_IN = 232448     # the shared bytes an H100 block may opt in to
SMEM_PER_SM = 233472     # an SM's, of which 1024 are reserved a block


@pytest.mark.parametrize("D,tiles,smem", [(64, (64, 64, 4, 2), 105472),
                                          (128, (128, 64, 3, 1), 204544),
                                          (256, (64, 64, 2, 1), 217600)])
def test_ffma_tiles_fit_shared_memory(D, tiles, smem):
    """The ffma tile per head width: the query rows a block (8 or 4 a
    thread of a 16 x 16 grid), 64-key K/V tiles, the ring's slots (at least
    2: one tile in flight while another is used), the blocks an SM, and the
    shared bytes: under the 232,448 a block may opt in to, and that many
    blocks (with the 1,024 bytes reserved for each) within an SM's."""
    assert tatt.FFMA_TILES[D] == tiles
    bq, bk, slots, blocks = tiles
    assert bq // 16 in (4, 8) and bk % 16 == 0 and slots >= 2
    assert tatt._ffma_smem_bytes(D) == smem <= SMEM_OPT_IN
    assert blocks * (smem + 1024) <= SMEM_PER_SM
    assert set(tatt.FFMA_TILES) == set(tatt.TILED_HEAD_DIMS)


def _live_key_tiles(qt, bq, Skv):
    """The causal key tiles of 64 a query tile reads."""
    return min(-(-Skv // 64), (qt * bq + bq - 1) // 64 + 1)


@pytest.mark.parametrize("B,Sq,H,D", [(8, 512, 32, 64), (8, 512, 10, 256),
                                      (1, 2080, 10, 256), (3, 141, 20, 128),
                                      (2, 200, 4, 64)])
def test_ffma_blocks_heaviest_first(B, Sq, H, D):
    """The launch order is a permutation of every (query tile, head, batch
    row), the query tiles with the most causal key tiles first, and the
    heads of one batch row side by side."""
    order = tatt._ffma_blocks(B, Sq, H, D)
    bq = tatt.FFMA_TILES[D][0]
    nq = -(-Sq // bq)
    assert sorted(order) == [(t, h, b) for t in range(nq) for h in range(H)
                             for b in range(B)]
    work = [_live_key_tiles(t, bq, Sq) for t, _, _ in order]
    assert work == sorted(work, reverse=True)
    assert [h for _, h, _ in order[:H]] == list(range(H))


@pytest.mark.parametrize("lead", [None, 3])
@pytest.mark.parametrize("dt", [np.float32, "bf16"])
def test_copy_block_pair_matches_jax(lead, dt):
    """copy_block on a (K, V) pair of CPU pools, flat and folded: each pool
    equal byte for byte to the Pallas kernel in interpret mode applied to
    it; the wrapper returns the pair it was given."""
    NB, bs, KV, D = 6, 4, 2, 16
    shape = (NB, bs, KV, D) if lead is None else (lead, NB, bs, KV, D)
    rng = np.random.RandomState(7)
    pools = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    tdt, jdt = (F32, jnp.float32) if dt is np.float32 else (BF, jnp.bfloat16)
    pair = tuple(torch.from_numpy(p.copy()).to(tdt) for p in pools)
    src, dst = 4, 1
    assert tdec.copy_block(pair, src, dst) is pair
    for t, p in zip(pair, pools):
        want = jops.copy_block(jnp.asarray(p).astype(jdt), src, dst,
                               interpret=True)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_copy_block_pair_checks():
    """A pair must share shape and dtype; at most two pools a call."""
    a = torch.zeros(4, 2, 1, 8)
    with pytest.raises(ValueError, match="pair"):
        tdec.copy_block((a, torch.zeros(5, 2, 1, 8)), 0, 1)
    with pytest.raises(ValueError, match="pair"):
        tdec.copy_block((a, a.to(BF)), 0, 1)
    with pytest.raises(ValueError, match="pair"):
        tdec.copy_block((a, a, a), 0, 1)
    with pytest.raises(ValueError, match="outside"):
        tdec.copy_block((a, a.clone()), 0, 4)


@pytest.mark.parametrize("kernel", [True, False])
def test_fork_copies_a_pair_in_one_call(monkeypatch, kernel):
    """The serving cache's fork: where the plan resolves copy_block to a
    kernel, one call a paged entry with its (K, V) pair; else the reference
    copy on each pool.  Either way block ``new`` of both pools becomes
    block ``old`` and the slot's table row points at it."""
    from repro_torch import flow
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import registry
    from repro_torch.serving.kvcache import PagedKVCache
    cm = flow.compile("llama3.2-1b", ShapeConfig("serve", "decode", 32, 2),
                      smoke=True, device="cpu")
    cache = PagedKVCache(cm.plan, 2, block_size=8, blocks_per_slot=4)
    calls = []

    def spy(pool, src, dst):
        calls.append((pool, src, dst))
        return tdec.copy_block(pool, src, dst)
    monkeypatch.setattr(registry, "plan_kernel",
                        lambda plan, op, **kw: spy if kernel else None)
    entries = cache._paged()
    for _, st in entries:
        st["kp"].copy_(torch.randn(st["kp"].shape))
        st["vp"].copy_(torch.randn(st["vp"].shape))
    before = [(st["kp"].clone(), st["vp"].clone()) for _, st in entries]
    cache._device_fork(1, 0, 3, 5)
    if kernel:
        assert [(len(p), s, d) for p, s, d in calls] == \
            [(2, 3, 5)] * len(entries)
        assert all(p[0] is st["kp"] and p[1] is st["vp"]
                   for (p, _, _), (_, st) in zip(calls, entries))
    else:
        assert calls == []
    for (e, st), (kp, vp) in zip(entries, before):
        for got, old in ((st["kp"], kp), (st["vp"], vp)):
            assert torch.equal(got[..., 5, :, :, :], old[..., 3, :, :, :])
            keep = [i for i in range(old.shape[-4]) if i != 5]
            assert torch.equal(got[..., keep, :, :, :],
                               old[..., keep, :, :, :])
        row = st["bt"][:, 1, 0] if e.nlead else st["bt"][1, 0]
        assert (row == 5).all()
