"""The kernel facade: the JAX package's ``kernels/ops.py`` names and
signatures over the port's wrappers.

Each function calls the hand kernel's wrapper, which launches the CUDA
kernel on a CUDA tensor (or raises) and runs its plain version on a CPU
tensor.  ``interpret`` is the Pallas interpret mode of the JAX facade; a
wrapper picks kernel or plain version by its operands' device, so it is
accepted and changes nothing.  ``tile`` is the JAX facade's TPU tile: only
the base variant of ``matmul_fused`` (``vmem_accum=False``) reads it (its K
extent is the slab depth, by default (256, 512, 256)'s 512); the other
kernels run their default Hopper tiles (a plan's Hopper tile reaches them
through the registry).
The op layer reaches the kernels through the registry
(:func:`repro_torch.kernels.registry.plan_kernel`), not through here; the
base variant has no op-layer caller and is reached through this facade,
as in the JAX package.
"""
from __future__ import annotations

from repro_torch.kernels import attention as _fa
from repro_torch.kernels import conv2d as _cv
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import matmul_fused as _mm


def matmul_fused(x, w, *, bias=None, w2=None, act=None, tile=None,
                 out_dtype=None, vmem_accum=True, interpret=False):
    return _mm.matmul_fused(
        x, w, bias=bias, w2=w2, act=act,
        tile=None if vmem_accum else tile or _mm.DEFAULT_TILE,
        out_dtype=out_dtype, vmem_accum=vmem_accum)


def flash_attention(q, k, v, positions=None, *, causal=True, window=None,
                    softcap=None, tile=None, q_offset=0, interpret=False):
    return _fa.flash_attention(
        q, k, v, positions=positions, causal=causal, window=window,
        softcap=softcap, q_offset=q_offset)


def decode_attention(q, kc, vc, pos, qpos, *, window=None, softcap=None,
                     tile=None, interpret=False):
    return _da.decode_attention(q, kc, vc, pos, qpos, window=window,
                                softcap=softcap, tile=tile)


def paged_decode_attention(q, kp, vp, bt, lens, *, qpos=None, window=None,
                           softcap=None, tile=None, interpret=False):
    # the pool block is the kernel's KV block: no tile (accepted for the
    # facade's uniformity, as in the JAX package)
    return _da.paged_decode_attention(q, kp, vp, bt, lens, qpos=qpos,
                                      window=window, softcap=softcap)


def copy_block(pool, src, dst, *, interpret=False):
    """Block ``dst`` := block ``src`` of ``pool`` (or of a (K, V) pair),
    in place, and the pool back (the JAX kernel returns the aliased
    pool)."""
    return _da.copy_block(pool, src, dst)


def conv2d_fused(x, w, *, stride=1, padding="SAME", bn=None, act=None,
                 tile=None, interpret=False):
    return _cv.conv2d_fused(x, w, stride=stride, padding=padding, bn=bn,
                            act=act)
