"""Weights across the frameworks: a parameter pytree given as numpy arrays
becomes the port's dict of tensors.

The layout is kept as it is: unfolded blocks are ``{block: {name: array}}``
and folded units are ``{"fold_<block>": {"<j>:<name>": stacked array}}``, the
leading axis running over the unit's repetitions (the JAX package's
``core/lowering.py`` ``init_params``).  A bfloat16 leaf (numpy's ``bfloat16``
extension dtype) goes through float32, which holds every bfloat16 value
exactly, and lands as ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike


def tensor_from_numpy(a: Any, device: DeviceLike = "cpu") -> torch.Tensor:
    """One leaf: numpy array (any float dtype, bfloat16 included) -> tensor
    of the same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32))
        return t.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = "cpu", *,
                      rules=None, plan=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nesting of tensors; with
    ``rules`` and ``plan`` (a mesh) DTensors under
    ``rules.params_shardings(plan)``, each rank keeping its chunk: the
    leaves are made on the host and only the chunks move to ``device``."""
    if rules is not None:
        return rules.distribute(params_from_numpy(tree, "cpu"),
                                rules.params_shardings(plan), device)
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else tensor_from_numpy(v, device) for k, v in tree.items()}
