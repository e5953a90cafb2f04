"""Random weights for one configuration, made on the device from the seed.

The benchmark makes them, in the dtype they are served in, one tensor per
call to the generator (a stacked tensor holds a weight of every layer), and
hands the same tensors to the program and to the reference. The layout is
the one the program's decoder takes: per-layer weights stacked under
``"layers"`` with a leading layer axis. Scales follow the usual fan-in rule
(``N(0, 1) / sqrt(fan_in)``); norm scales are zero under the
``(1 + scale)`` convention, so every norm starts as the identity. Which
tensors there are, and in what order the generator makes them, is the
architecture's (``arch/<name>.py``).
"""
from __future__ import annotations

from typing import Dict

import torch

from mars_bench import arch


def make_params(cfg: Dict, seed: int, *, dtype=torch.bfloat16,
                device="cuda") -> Dict:
    """The weights of ``cfg`` (a ``configs/<name>.json``'s numbers)."""
    return arch.module(cfg).make_params(cfg, seed, dtype=dtype,
                                        device=device)
