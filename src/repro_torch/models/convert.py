"""Carries the JAX package's parameters across to the port.

``repro.models.model_zoo.init`` returns a pytree of arrays, with the
per-layer weights stacked under ``"layers"``. The caller turns it into
numpy (``jax.tree.map(np.asarray, params)``) and hands it here: the port
itself never imports JAX. The result has the layout
:func:`repro_torch.models.transformer.init_lm` produces, so the same
weights drive both packages and their outputs can be compared.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_numpy(tree: Mapping[str, Any], *, dtype=None,
                      device="cpu") -> dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device``; floating arrays are cast to ``dtype`` when given (bf16
    arrays arrive from numpy as float32 or ml_dtypes bfloat16, both fine)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = params_from_numpy(val, dtype=dtype, device=device)
            continue
        arr = np.asarray(val)
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)      # exact: bf16 embeds in f32
        t = torch.from_numpy(np.array(arr, order="C", copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[key] = t.to(device)
    return out
