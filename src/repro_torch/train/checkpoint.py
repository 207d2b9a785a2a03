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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


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
    host = {k: _to_host(k, v) for k, v in _flatten(tree).items()}

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
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


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


def restore(ckpt_dir: str, step: int, like):
    """The checkpoint of ``step`` in the structure of ``like``: each leaf a
    new tensor of the dtype and device of ``like``'s leaf at that key."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    out = {}
    for k, leaf in _flatten(like).items():
        arr = np.load(os.path.join(d, meta["leaves"][k]))
        out[k] = torch.from_numpy(arr).to(device=leaf.device,
                                          dtype=leaf.dtype)
    return _unflatten(like, out)
