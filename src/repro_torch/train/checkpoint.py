"""Checkpoints in the JAX package's on-disk format, with async save.

Layout (the JAX package's ``train/checkpoint.py``): ``step_%08d/`` holds one
``leaf_%05d.npy`` per leaf and ``meta.json`` mapping each leaf's path key to
its file.  The keys and their order are those of
``jax.tree_util.tree_flatten_with_path``: dict keys sorted, an
:class:`~repro_torch.optim.adamw.AdamWState` field as ``.<name>``, a
``None`` field (no error buffers) left out, joined by ``/``
(``opt/.mu/fold_layer0/0:attn_norm_scale``).  So either package restores
the other's checkpoints.  Saves go through a temp dir + rename (a crash
mid-save never corrupts the latest checkpoint) and can run on a thread.

numpy has no bfloat16 of its own, so a bfloat16 leaf raises ``TypeError``
before anything is written; training trees are fp32 (the masters, the
moments) with an int32 step.

A DTensor leaf (a tree trained on a mesh) is saved whole: every rank
gathers it and the first rank writes.  ``restore(..., shardings=)`` places
each leaf on a mesh and placements of the caller's choice, each rank
keeping its chunk — the elastic path: a checkpoint saved on one mesh
resumes on another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path key: leaf} in ``tree_flatten_with_path`` order, for nested
    dicts and NamedTuples (the trees the trainer saves)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for seg, v in items:
        out.update(_flatten(v, f"{prefix}/{seg}" if prefix else seg))
    return out


def _unflatten(like, values: Dict[str, Any], prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``values[key]``."""
    def key(seg):
        return f"{prefix}/{seg}" if prefix else seg
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, values, key(str(k))) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), values, key("." + f))
                            for f in like._fields))
    return values[prefix]


def _to_host(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        from repro_torch.distributed.sharding import full_tensor
        leaf = full_tensor(leaf)
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {key!r} is bfloat16, which numpy cannot "
                "store; cast the tree to float32 first")
        # a copy: the train step updates the caller's tensors in place
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save(ckpt_dir: str, step: int, tree, wait: bool = True,
         keep: int = 3) -> Optional[threading.Thread]:
    """Write the checkpoint of ``step``.  The leaves are copied to the host
    before this returns; with ``wait=False`` the files are written on a
    thread, which is returned."""
    flat = _flatten(tree)
    host = {k: _to_host(k, v) for k, v in flat.items()}
    sharded = any(isinstance(v, DTensor) for v in flat.values())
    if sharded and _rank() != 0:        # the first rank writes
        _barrier(wait)
        return None

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp_{step}")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        names = {}
        for i, (k, v) in enumerate(host.items()):
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), v)
            names[k] = fn
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "leaves": names}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if wait:
        _write()
        if sharded:
            _barrier(wait)
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier(wait: bool) -> None:
    """A saved sharded tree is on disk for every rank once ``save`` returns
    (with ``wait``)."""
    import torch.distributed as dist
    if wait and dist.is_initialized():
        dist.barrier()


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """The checkpoint of ``step`` in the structure of ``like``: each leaf a
    new tensor of the dtype and device of ``like``'s leaf at that key.
    ``shardings`` (a tree like ``like``'s of
    :class:`~repro_torch.distributed.sharding.NamedSharding`, ``None``
    fields left out) places each leaf it names as a DTensor on that mesh
    and spec; a DTensor leaf of ``like`` it does not name keeps that
    leaf's mesh and placements.  A placed leaf is read whole on the host
    and only the rank's chunk moves to the device."""
    from repro_torch.distributed.sharding import ShardingRules
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    where = _flatten(shardings) if shardings is not None else {}
    out = {}
    for k, leaf in _flatten(like).items():
        arr = np.load(os.path.join(d, meta["leaves"][k]))
        sh = where.get(k)
        if sh is None and isinstance(leaf, DTensor):
            sh = _Placed(leaf.device_mesh, leaf.placements)
        loc = leaf._local_tensor if isinstance(leaf, DTensor) else leaf
        full = torch.from_numpy(arr)
        out[k] = full.to(device=loc.device, dtype=loc.dtype) if sh is None \
            else ShardingRules(sh.mesh).place(full, sh, loc.device, loc.dtype)
    return _unflatten(like, out)


class _Placed(NamedTuple):
    """A DTensor's own mesh and placements (what ``ShardingRules.place``
    reads of a sharding), to restore a leaf as it was."""
    mesh: Any
    placements: tuple
