"""Carries the JAX package's parameters across to the port.

``repro.models.model_zoo.init`` returns a pytree of arrays, with the
per-layer weights stacked under ``"layers"``. The caller turns it into
numpy (``jax.tree.map(np.asarray, params)``) and hands it here: the port
itself never imports JAX. The result has the layout the port's own init
functions produce (``transformer.init_lm``, ``rwkv6.init_rwkv``), so the
same weights drive both packages and their outputs can be compared.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

F32 = torch.float32


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> torch with the same dtype; bf16 (ml_dtypes) goes through
    its bits, which torch.from_numpy cannot take directly."""
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr.view(np.uint16), order="C", copy=True)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C", copy=True))


def params_from_numpy(tree: Mapping[str, Any], *, dtype=None,
                      device="cpu") -> dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device``, each leaf in the dtype the JAX init gave it: a bf16 tree
    keeps its f32 leaves (rwkv6's ``u``, ``w_base``, ``ln_x_scale``).
    ``dtype``, when given, is the model dtype the tree was drawn in: a
    floating leaf in neither it nor float32 raises."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = params_from_numpy(val, dtype=dtype, device=device)
            continue
        t = _tensor(np.asarray(val))
        if dtype is not None and t.is_floating_point() and \
                t.dtype not in (dtype, F32):
            raise TypeError(f"leaf {key!r} is {t.dtype}, the tree's model "
                            f"dtype is {dtype}")
        out[key] = t.to(device)
    return out
