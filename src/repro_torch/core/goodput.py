"""Dynamic SLO-Aware Goodput (paper Eq. 1-2).

    G(t) = (1/dt) * sum_{i in W_dt} 1[L_i <= tau_i],   tau_i = alpha * T_ideal(i)

T_ideal is the session's isolated (concurrency-1) execution time, computed by
the same analytic perf model the simulator uses (the paper measures it with
max-concurrency-1 vLLM runs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.session import Session


@dataclass
class LatencyStats:
    mean: float
    p50: float
    p90: float
    p95: float
    p99: float
    n: int

    @classmethod
    def of(cls, xs: Sequence[float]) -> "LatencyStats":
        if not xs:
            return cls(float("nan"), float("nan"), float("nan"),
                       float("nan"), float("nan"), 0)
        a = np.asarray(xs, np.float64)
        return cls(float(a.mean()), *(float(np.percentile(a, p))
                                      for p in (50, 90, 95, 99)), len(a))


def goodput(finished: Sequence[Session], horizon: float, alpha: float) -> float:
    """Completed-within-SLO requests per second over the run horizon."""
    ok = sum(1 for s in finished
             if s.e2e_latency <= alpha * s.ideal_time)
    return ok / max(horizon, 1e-9)


def token_throughput(finished: Sequence[Session], horizon: float) -> float:
    toks = sum(sum(r.decode_tokens for r in s.rounds) for s in finished)
    return toks / max(horizon, 1e-9)


def summarize(finished: Sequence[Session], horizon: float,
              alphas: Sequence[float] = (1.0, 2.0, 3.0)) -> Dict:
    lat = LatencyStats.of([s.e2e_latency for s in finished])
    ttfts: List[float] = []
    for s in finished:
        ttfts.extend(s.ttfts)
    return {
        "n_finished": len(finished),
        "latency": lat,
        "ttft": LatencyStats.of(ttfts),
        "goodput": {a: goodput(finished, horizon, a) for a in alphas},
        "token_throughput": token_throughput(finished, horizon),
        "completion_rate": len(finished),
    }
