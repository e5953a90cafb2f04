"""Synthetic token data pipeline: deterministic, shardable, prefetchable.

Produces packed (tokens, targets) LM batches; the iterator is seeded and
stateless-resumable (``state_dict``/``load_state_dict``) so training restarts
reproduce the exact stream — part of the fault-tolerance story.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLMStream:
    """Zipf-distributed token stream packed into fixed-length rows."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._step = 0

    def state_dict(self) -> Dict:
        return {"step": self._step}

    def load_state_dict(self, d: Dict) -> None:
        self._step = int(d["step"])

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, self._step))
        self._step += 1
        z = rng.zipf(1.3, size=(c.global_batch, c.seq_len + 1))
        toks = (z % (c.vocab_size - 2)) + 1
        return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()
