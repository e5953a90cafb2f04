"""Live serving bench of the PyTorch port: the generator's agentic trace
(``workloads/generator.py``, regime ILR-1) served by MARS on
``TorchBackend`` (paged layout, ``scheduler="mixed"``, real tool threads)
on one card, with random bf16 weights at the config's full width.

    python3 benchmarks_torch/serving_bench.py --cell qwen3coder-ilr1-kvpressure-1chip
    python3 benchmarks_torch/serving_bench.py --cell llama1b-ilr1-families-1chip
    # the separate traced run (per-layer metrics, tracing on):
    python3 benchmarks_torch/serving_bench.py --cell ... --traced
    # the rate sweep that fixed each cell's arrival rate (weights built once):
    python3 benchmarks_torch/serving_bench.py --cell ... --rates 0.05,0.1,0.2
    # on the CPU: the cell's config .reduced() in float32 at CPU_SIZES
    python3 benchmarks_torch/serving_bench.py --cell ... --device cpu

Every end-to-end metric is printed by name with its unit and sample count
(``[metric]`` lines): a timing as its median and the highest percentile
that has at least ten samples beyond it. Tracing is off in the default
run; ``--traced`` runs the same cell again with the obs ``Tracer``, spans
around the bench's calls into the backend and a profiler window, and
prints the per-layer metrics (``[layer]`` lines). ``--json OUT`` writes
the result. The exit code is 1 when ``correct`` is false:

* every finished session decoded exactly its rounds' token counts;
* ``Engine.check_invariants()`` holds after the run;
* on the card, both paged kernels launched during the sessions;
* a teacher-forced re-score of ``RESCORE_SESSIONS`` seed-chosen sessions
  through the non-paged path (``lm_step`` chunks on a fresh dense cache:
  the ``flash_attention`` kernel, not the paged ones), with logits formed
  only at the positions whose output was served: each served token's
  re-scored logit lies within ``TAU_Z`` standard deviations (of that
  position's logits over the vocabulary) of the position's maximum.

No check compares free-running tokens between runs or policies: under
MoE, bf16 routes flip at near ties (ROADMAP.md §3).

``--device cuda`` (the default) needs a card and raises without one; a
kernel that fails to build or launch raises. Nothing falls back to the
CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

if __package__ in (None, ""):            # run as a script from the checkout
    _ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [os.path.join(_ROOT, "src"), _ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import qwen3_coder_30b  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core.events import EventBus  # noqa: E402
from repro_torch.engine.engine import Engine, EngineConfig, run_live  # noqa: E402
from repro_torch.engine.tools import RealToolExecutor  # noqa: E402
from repro_torch.engine.torch_runner import TorchBackend, _bucket  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_fused)
from repro_torch.kernels.paged_flash_attention import \
    paged_flash_attention  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6  # noqa: E402
from repro_torch.models import perf_model as pm  # noqa: E402
from repro_torch.models.transformer import (KVCache, _unembed,  # noqa: E402
                                            init_lm, lm_mixed_paged, lm_step)
from repro_torch.workloads.generator import WorkloadSpec, generate  # noqa: E402

PAGE = 32
ALPHA = 3.0              # the paper's SLO: e2e <= ALPHA x the ideal time
CPU_SLOTS = 8            # tool threads and swap staging lease from these
                         # (the cores of the card's machine)
RESCORE_SESSIONS = 4
# a served token's re-scored logit may sit at most TAU_Z standard
# deviations (of that position's logits over the vocabulary) below the
# position's maximum. The logits of the random-weight models spread about
# one unit over the vocabulary, the top few tokens lie within a few tenths
# of one another, and a token chosen from a corrupted context lands
# several deviations below the maximum; bf16 noise and an MoE route
# flipped at a near tie move the served token's logit by much less
TAU_Z = 1.0
PCTS = (99.9, 99.0, 95.0, 90.0, 75.0)   # candidates above the median
PROFILE_AFTER, PROFILE_TICKS = 20, 10   # the traced run's profiler window
LANE_RUN = 8             # decode positions a re-score call takes at most:
                         # layers._capacity never goes below 8
KERNELS = {"paged_attention_fused": paged_attention_fused,
           "paged_flash_attention": paged_flash_attention,
           "paged_attention": paged_attention,
           "flash_attention": flash_attention, "wkv6": wkv6}
MAIN_PATH = ("paged_attention_fused", "paged_flash_attention")


@dataclass
class Cell:
    """One model configuration under one traffic mix. ``spec`` holds the
    ``WorkloadSpec`` fields (the seed comes from the command line)."""
    name: str
    arch: str
    total_pages: int             # device KV pool, pages of PAGE tokens
    host_tier_blocks: int        # host-DRAM tier capacity (blocks)
    token_budget: int            # tokens per engine iteration
    max_decode_batch: int
    spec: Dict = field(default_factory=dict)
    timeout_s: float = 240.0     # sessions unfinished by then have failed
    reduced: tuple = ()          # the cuts of scale from the deployment
    why: str = ""


# arrival rates: 0.7 x the highest rate ``sustained`` in a sweep on one
# H100 80GB HBM3 at 700 W (--rates; PERF.md §4): qwen 0.4 / 0.6 / 0.8 /
# 1.2 per s sustained up to 0.8, llama 0.5 / 0.625 / 0.75 / 1.0 up to 0.75
CELLS = {c.name: c for c in (
    Cell(
        name="qwen3coder-ilr1-kvpressure-1chip", arch="qwen3-coder-30b-a3b",
        total_pages=4096, host_tier_blocks=8192, token_budget=2048,
        max_decode_batch=16,
        spec=dict(regime="ILR-1", max_context=16_384, n_sessions=12,
                  rounds_lo=3, rounds_hi=6, decode_mean=64,
                  tool_time_scale=0.02, arrival_rate=0.56),
        reduced=("context 256K -> 16K", "decode_mean 220 -> 64",
                 "tool times x 0.02", "12 sessions"),
        why="the paper's model and operating point on one H100: 61.1 GB of "
            "bf16 weights leave 4,096 pages (131,072 tokens, 12.9 GB) for "
            "~167K tokens of live contexts, so MARS's pin/offload/drop "
            "choices decide the resumed-round TTFT; the MoE products "
            "dominate the device time"),
    Cell(
        name="llama1b-ilr1-families-1chip", arch="llama3.2-1b",
        total_pages=8192, host_tier_blocks=16_384, token_budget=2048,
        max_decode_batch=32,
        spec=dict(regime="ILR-1", max_context=32_768, n_sessions=32,
                  n_families=4, shared_frac=0.7, dup_frac=0.1,
                  rounds_lo=3, rounds_hi=6, decode_mean=64,
                  tool_time_scale=0.02, arrival_rate=0.525),
        reduced=("KV pool held to 8.6 GB (a deployment gives ~60 GB) so "
                 "that 32 sessions press it", "context 256K -> 32K",
                 "decode_mean 220 -> 64", "tool times x 0.02",
                 "32 sessions"),
        why="prefix sharing (4 families share 0.7 of round 0), CoW and the "
            "host-bound mixed iteration of a small dense model; the MoE "
            "products of the first cell are absent"),
)}
# the CPU run (--device cpu, the tests): the config .reduced() in float32
# (the generator's prompts are at least 2,000 tokens: the pool of 96
# pages holds one such session and part of another)
CPU_SIZES = dict(total_pages=96, host_tier_blocks=512, token_budget=256,
                 max_decode_batch=4, timeout_s=120.0)
CPU_SPEC = dict(max_context=2048, n_sessions=4, rounds_lo=2, rounds_hi=3,
                decode_mean=24, tool_time_scale=0.002, arrival_rate=2.0)


def cut(cell: Cell, **spec) -> Cell:
    """``cell`` with some of its ``WorkloadSpec`` fields replaced."""
    return dataclasses.replace(cell, spec={**cell.spec, **spec})


def cpu_cell(cell: Cell) -> Cell:
    out = dataclasses.replace(cut(cell, **CPU_SPEC), **CPU_SIZES)
    if out.spec.get("n_families"):
        out.spec["n_families"] = 2
    return out


def workload(cell: Cell, seed: int) -> WorkloadSpec:
    return WorkloadSpec(seed=seed, slo_alpha=ALPHA, chunk_tokens=PAGE,
                        **cell.spec)


def cell_config(cell: Cell, device: torch.device):
    """The cell's model config: as published on the card, ``.reduced()``
    on the CPU. Qwen3-Coder is read from its config module (the registry
    names the assigned architectures only)."""
    cfg = (qwen3_coder_30b.CONFIG if cell.arch == "qwen3-coder-30b-a3b"
           else get_config(cell.arch))
    return cfg.reduced() if device.type == "cpu" else cfg


def engine_config(cell: Cell) -> EngineConfig:
    return EngineConfig(
        total_kv_blocks=cell.total_pages, block_size=PAGE,
        token_budget=cell.token_budget,
        max_decode_batch=cell.max_decode_batch, scheduler="mixed",
        cpu_slots=CPU_SLOTS, host_tier_blocks=cell.host_tier_blocks)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "for the reduced config on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def build_params(cell: Cell, *, seed: int = 0, device="cuda"):
    """Random weights from ``seed``: bf16 at full width on the card,
    float32 ``.reduced()`` on the CPU."""
    dev = _device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_lm(cell_config(cell, dev), gen, dtype, dev)


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------

def summary(xs) -> dict:
    """Median and the highest of ``PCTS`` with at least ten samples
    beyond it (None where the sample is too small), with the count."""
    a = np.asarray(list(xs), np.float64)
    out = {"n": int(a.size), "median": None, "pct": None, "tail": None}
    if a.size:
        out["median"] = float(np.median(a))
        for p in PCTS:
            if a.size * (1 - p / 100) >= 10:
                out["pct"], out["tail"] = p, float(np.percentile(a, p))
                break
    return out


def _fmt(x) -> str:
    return "not measured" if x is None else f"{x:.6g}"


def metric_line(tag: str, name: str, m: dict, unit: str) -> str:
    if "median" in m:
        tail = (f", p{m['pct']:g} {_fmt(m['tail'])} {unit}" if m["pct"]
                else ", no percentile above the median has 10 samples "
                     "beyond it")
        return (f"[{tag}] {name}: median {_fmt(m['median'])} {unit}{tail} "
                f"(n={m['n']})")
    return f"[{tag}] {name}: {_fmt(m['value'])} {unit} (n={m['n']})"


# ---------------------------------------------------------------------------
# warm-up: every bucket shape of the mixed iteration, parked on scratch
# ---------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _scratch_iteration(backend: TorchBackend, *, P: int, C: int, Np: int,
                       B: int, maxp: int, length: int = 1) -> None:
    """One ``lm_mixed_paged`` call of P packs of C tokens (tables Np wide)
    and B decode lanes of ``length`` keys (tables maxp wide), every table
    entry and every write on the scratch page, as ``calibrate`` parks its
    calls: the pool's real pages are never touched."""
    impl = backend._impl
    sc, page, t = impl.scratch, impl.page, impl._t
    i32 = np.int32
    length = min(length, maxp * page)
    _p, _d, impl.cache = lm_mixed_paged(
        backend.cfg, backend.params, impl.cache,
        t(np.zeros((P, 1, C), i32)),
        t(np.tile(np.arange(C, dtype=i32), (P, 1, 1))),
        t(np.full((P, Np), sc, i32)), t(np.full((P, C), sc, i32)),
        t(np.tile(np.arange(C, dtype=i32) % page, (P, 1))),
        t(np.full((P,), C, i32)), t(np.full((P,), C - 1, i32)),
        t(np.zeros((B,), i32)), t(np.full((B,), length - 1, i32)),
        t(np.full((B, maxp), sc, i32)), t(np.full((B,), length, i32)),
        t(np.full((B,), sc, i32)), t(np.full((B,), (length - 1) % page, i32)))
    _p.cpu(), _d.cpu()           # the engine reads every iteration back


def warm_up(backend: TorchBackend, cell: Cell, max_ctx: int,
            mean_ctx: int) -> dict:
    """Visit every ``_bucket`` shape the run can give the mixed iteration
    (each chunk bucket up to the token budget; each lane bucket up to
    ``max_decode_batch``; the widest tables the sessions' longest context
    needs), so that no first visit of a shape lands in the timed window.
    Then time a batch-1 decode step at the sessions' mean context (the
    measured ideal's decode rate) and a full-budget chunk."""
    dev = backend.device
    page = backend._impl.page
    Np = _bucket(-(-(max_ctx + cell.token_budget) // page) + 1, lo=2)
    maxp = _bucket(-(-max_ctx // page), lo=1)
    top_c = _bucket(cell.token_budget)
    top_b = _bucket(cell.max_decode_batch, lo=1)
    C = 32
    while C <= top_c:
        _scratch_iteration(backend, P=1, C=C, Np=Np, B=0, maxp=1)
        C *= 2
    B = 1
    while B <= top_b:
        _scratch_iteration(backend, P=0, C=1, Np=2, B=B, maxp=maxp,
                           length=mean_ctx)
        B *= 2
    _scratch_iteration(backend, P=2, C=top_c, Np=Np, B=top_b, maxp=maxp,
                       length=mean_ctx)

    def timed(fn, n):
        out = []
        for _ in range(n):
            _sync(dev)
            t0 = time.monotonic()
            fn()
            _sync(dev)
            out.append(time.monotonic() - t0)
        return float(np.median(out))

    dec1 = timed(lambda: _scratch_iteration(
        backend, P=0, C=1, Np=2, B=1, maxp=maxp, length=mean_ctx), 5)
    chunk = timed(lambda: _scratch_iteration(
        backend, P=1, C=top_c, Np=Np, B=0, maxp=1), 3)
    return {"decode1_s": dec1, "chunk_tok_s": top_c / chunk}


# ---------------------------------------------------------------------------
# the bench's spans around its calls into the backend
# ---------------------------------------------------------------------------

class _Writes:
    """Per session, what each call into the model wrote: the token fed at
    each position, and the calls in order, ``("pack", start, n, C)`` for a
    prefill pack of n tokens padded to C, ``("lane", pos, served)`` for a
    decode lane and ``("gap", a, b)`` for positions attached from the
    radix (another session built them). A call that rewrites positions
    already fed (a recompute after a drop or a preemption) starts a new
    epoch, so every served token is re-scored against the context it was
    served from."""

    def __init__(self):
        self.cur: Dict[int, dict] = {}
        self.done: Dict[int, List[dict]] = {}

    def _epoch(self, s, pos: int) -> dict:
        e = self.cur.setdefault(s.sid, {"fed": [], "ops": []})
        if pos < len(e["fed"]):             # rewrite: a new epoch that
            self.done.setdefault(s.sid, []).append(e)   # keeps the calls
            ops = []                                    # below ``pos``
            for kind, at, *rest in e["ops"]:
                if at >= pos:
                    continue
                if kind == "lane":              # served in the old epoch
                    ops.append(("lane", at, None))
                elif kind == "pack":
                    ops.append(("pack", at, min(rest[0], pos - at), rest[1]))
                else:
                    ops.append(("gap", at, min(rest[0], pos)))
            e = self.cur[s.sid] = {"fed": e["fed"][:pos], "ops": ops}
        if pos > len(e["fed"]):             # attached radix prefix: round-0
            e["ops"].append(("gap", len(e["fed"]), pos))     # content
            e["fed"].extend(s.meta["context_ids"][len(e["fed"]):pos])
        return e

    def pack(self, s, start: int, toks, C: int) -> None:
        e = self._epoch(s, start)
        e["fed"].extend(toks)
        e["ops"].append(("pack", start, len(toks), C))

    def lane(self, s, pos: int, fed: int, out: int) -> None:
        e = self._epoch(s, pos)
        e["fed"].append(fed)
        e["ops"].append(("lane", pos, out))

    def epochs(self, sid: int) -> List[dict]:
        return self.done.get(sid, []) + ([self.cur[sid]]
                                         if sid in self.cur else [])


class _Spans:
    """Wraps ``backend._impl.run_mixed``: records what each decode lane
    and prefill pack wrote (for the re-score) and, in the traced run, each
    iteration's host seconds."""

    def __init__(self, backend: TorchBackend, timed: bool):
        self.writes = _Writes()
        self.iter_s: List[float] = []
        impl = backend._impl
        inner = impl.run_mixed

        def run_mixed(work):
            lanes = [(s, s.resident_len, s.meta.get("next_token", 1))
                     for s, _g in work.decodes]
            t0 = time.perf_counter()
            inner(work)
            if timed:
                self.iter_s.append(time.perf_counter() - t0)
            # every pack of the iteration is padded to one bucket
            C = _bucket(max((c for _s, c in work.prefills), default=1))
            for s, chunk in work.prefills:
                start = s.resident_len
                self.writes.pack(
                    s, start, s.meta["context_ids"][start:start + chunk], C)
            for s, pos, fed in lanes:
                self.writes.lane(s, pos, fed, s.meta["generated"][-1])

        impl.run_mixed = run_mixed


class _TickProfiler:
    """The traced run's profiler window: ``PROFILE_TICKS`` working ticks
    after the first ``PROFILE_AFTER``, bracketed by synchronisations; the
    device-busy share is the device time of the window's kernels and
    copies over its wall. The trace is read after the run (``read``), so
    that its post-processing does not stall the sessions; ``stop_s`` is
    the stall that stopping the profiler still puts into the run."""

    def __init__(self, eng: Engine, dev: torch.device):
        from torch.profiler import ProfilerActivity, profile
        self.wall = self.stop_s = None
        self._n = 0
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        inner = eng.tick

        def tick(now):
            if self._n == PROFILE_AFTER and self.wall is None:
                torch.cuda.synchronize(dev)
                self._prof.start()
                self._t0 = time.monotonic()
            out = inner(now)
            if out[0] > 0:
                self._n += 1
            if self._n == PROFILE_AFTER + PROFILE_TICKS and \
                    self.wall is None:
                torch.cuda.synchronize(dev)
                t1 = time.monotonic()
                self.wall = t1 - self._t0
                self._prof.stop()
                self.stop_s = time.monotonic() - t1
            return out

        eng.tick = tick

    def read(self) -> dict:
        if self.wall is None:                # the run had too few ticks
            return {"busy_frac": None}
        evs = [e for e in self._prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0
               and "CUDA" in str(getattr(e, "device_type", ""))]
        busy = sum(e.device_time_total for e in evs) / 1e6
        return {"ticks": PROFILE_TICKS, "wall_s": self.wall,
                "device_s": busy, "stop_s": self.stop_s,
                "busy_frac": busy / self.wall if evs else None}


# ---------------------------------------------------------------------------
# correctness: the teacher-forced re-score on the non-paged path
# ---------------------------------------------------------------------------

def _calls(e: dict, last: int, chunk: int) -> List[tuple]:
    """The re-score's ``lm_step`` calls (start, n, C) for one epoch, up to
    position ``last``. An MoE layer's capacity dispatch couples the tokens
    of a call (``layers._capacity``; overflow is dropped in token-major
    order), so the calls replay the served ones: each pack at its start,
    length and padded width (its tokens' drops depend only on the tokens
    before them and the capacity), consecutive decode lanes in runs of at
    most ``LANE_RUN`` tokens (below the capacity floor: nothing is
    dropped, as almost never in a served decode batch). Radix-attached
    gaps go in ``chunk``-token calls: exact for a dense model, not for an
    MoE one (no cell has both)."""
    calls, run = [], None
    for op in e["ops"]:
        if op[0] == "lane":
            if run and run[0] + run[1] == op[1] and run[1] < LANE_RUN:
                run[1] += 1
                continue
            if run:
                calls.append((run[0], run[1], run[1]))
            run = [op[1], 1]
            continue
        if run:
            calls.append((run[0], run[1], run[1]))
            run = None
        if op[0] == "pack":
            calls.append(op[1:])
        else:
            calls += [(a, min(chunk, op[2] - a), min(chunk, op[2] - a))
                      for a in range(op[1], op[2], chunk)]
    if run:
        calls.append((run[0], run[1], run[1]))
    return [c for c in calls if c[0] <= last]


def rescore(cfg, params, spans: _Spans, sids, *, chunk: int,
            dev: torch.device) -> dict:
    """Re-run each epoch of each session in ``sids`` through ``lm_step``
    on a fresh dense cache (the flash kernel, in calls of at most a pack:
    no score matrix of the whole context), form logits only at the
    positions whose output was served, and measure how far below each
    position's maximum the served token's logit lies, in standard
    deviations of that position's logits."""
    gaps: List[float] = []
    dtype = params["embed"].dtype
    flash0 = flash_attention.launches
    with torch.no_grad():
        for sid in sids:
            for e in spans.writes.epochs(sid):
                want = {op[1]: op[2] for op in e["ops"]
                        if op[0] == "lane" and op[2] is not None}
                if not want:
                    continue
                fed = e["fed"]
                # one slot past the context: padded rows park there
                cache = KVCache.zeros(cfg, 1, len(fed) + 1, dtype, dev)
                for start, n, C in _calls(e, max(want), chunk):
                    toks = fed[start:start + n] + [0] * (C - n)
                    h, cache = lm_step(
                        cfg, params, cache,
                        torch.tensor([toks], dtype=torch.int32, device=dev),
                        q_offset=start, n_real=n, return_hidden=True)
                    rows = [p for p in range(start, start + n) if p in want]
                    if not rows:
                        continue
                    idx = torch.tensor([p - start for p in rows], device=dev)
                    logits = _unembed(cfg, params, h[0, idx]).float()
                    top = logits.max(dim=-1).values
                    sd = logits.std(dim=-1)
                    tok = torch.tensor([want[p] for p in rows], device=dev)
                    got = logits.gather(1, tok[:, None])[:, 0]
                    gaps += ((top - got) / sd).tolist()
                del cache
    a = np.asarray(gaps)
    return {"sids": list(sids), "tokens": int(a.size),
            "flash_launches": flash_attention.launches - flash0,
            "max_gap_z": float(a.max()) if a.size else 0.0,
            "p99_gap_z": float(np.percentile(a, 99)) if a.size else 0.0,
            "ok": bool(a.size) and float(a.max()) <= TAU_Z}


# ---------------------------------------------------------------------------
# one run of a cell
# ---------------------------------------------------------------------------

def _launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _zero_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def measured_ideal(s, prefill_rate: float, decode1_s: float) -> float:
    """The session alone on this card: its tool seconds, its prompt at
    the backend's calibrated prefill rate, its decode tokens at the
    measured batch-1 decode step."""
    return sum(r.tool_seconds + r.decode_tokens * decode1_s
               + r.new_input_tokens / prefill_rate for r in s.rounds)


def _itl(bus: EventBus) -> List[float]:
    """Gaps between a session's consecutive decode steps in one round
    (DECODE_STEP carries each iteration's end), the first token of each
    round excluded (that is its TTFT)."""
    last: Dict[tuple, float] = {}
    out = []
    for e in bus.of_kind(ev.DECODE_STEP):
        key = (e.sid, e.data["round"])
        if key in last:
            out.append(e.t - last[key])
        last[key] = e.t
    return out


def sustained(res: dict) -> bool:
    """The bench's rule for a rate the cell sustains: no session failed,
    the median session's e2e stays within ALPHA x its ideal, and the
    backlog does not grow: the later half of the arrivals waits for its
    first token (admission, the prefill queue and its own prefill) no
    longer than twice the earlier half's wait plus 1 s (medians)."""
    e = res["e2e"]
    waits = res["ttft0_by_arrival_s"]
    half = len(waits) // 2
    grow = (float(np.median(waits[half:])) >
            2 * float(np.median(waits[:half])) + 1.0) if half else False
    slow = e["slowdown"]["median"]
    return (e["failed_frac"]["value"] == 0 and slow is not None
            and slow <= ALPHA and not grow)


def run(cell: Cell, *, seed: int = 0, policy: str = "mars", device="cuda",
        params=None, traced: bool = False,
        install: Optional[Callable] = None,
        say: Callable[[str], None] = print) -> dict:
    """Serve ``cell`` once and check it; returns the result (see
    ``report``). ``params`` reuses weights from ``build_params``;
    ``install(engine, backend)`` runs before the sessions arrive (a test's
    fault hook)."""
    dev = _device(device)
    cfg = cell_config(cell, dev)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    build_s = None
    if dev.type == "cuda":                # nvcc, before the set-up clock
        t0 = time.monotonic()
        _build.build_all()
        build_s = time.monotonic() - t0
    t_setup = time.monotonic()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if params is None:
        params = build_params(cell, seed=seed, device=dev)
    sessions = generate(workload(cell, seed), cfg, pm.H100)
    ctx = [s.total_prompt_tokens + sum(r.decode_tokens for r in s.rounds)
           for s in sessions]
    backend = TorchBackend(cfg, params=params, layout="paged",
                           total_pages=cell.total_pages, page_size=PAGE,
                           max_slots=cell.max_decode_batch, device=dev,
                           dtype=dtype)
    bus = EventBus()
    tools = RealToolExecutor(cpu_slots=CPU_SLOTS, bus=bus)
    try:
        warm = warm_up(backend, cell, max(ctx), int(np.mean(ctx)))
        warm["prefill_rate"] = backend.prefill_rate()
        for s in sessions:
            s.meta["ideal_modelled_s"] = s.ideal_time
            s.ideal_time = measured_ideal(s, backend.prefill_rate(),
                                          warm["decode1_s"])
        eng = Engine(engine_config(cell), policy, backend, bus=bus,
                     tool_exec=tools)
        spans = _Spans(backend, timed=traced)
        tracer = prof = None
        if traced:
            from repro_torch.obs import Tracer
            tracer = Tracer.install(eng)
            if dev.type == "cuda":
                prof = _TickProfiler(eng, dev)
        if install is not None:
            install(eng, backend)
        _sync(dev)
        setup_s = time.monotonic() - t_setup
        late: List[float] = []
        submit = eng.submit

        def submit_late(s):
            late.append(time.monotonic() - t_run - s.arrival_time)
            return submit(s)

        eng.submit = submit_late
        _zero_launches()
        t_run = time.monotonic()
        finished, horizon = run_live(eng, sessions, timeout=cell.timeout_s)
        _sync(dev)
        wall = time.monotonic() - t_run
        launches = _launches()
        try:
            eng.check_invariants()
            invariants = True
        except AssertionError as exc:
            say(f"[check] invariants broken: {exc}")
            invariants = False
    finally:
        tools.shutdown()
        backend.close()
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    stats = dict(backend.dispatch_stats)
    backend._impl.cache = None                 # the pool goes before the
    del backend                                # re-score's dense caches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    res = e2e_metrics(cell, sessions, finished, wall, eng, bus, late)
    res.update(cell=cell.name, policy=policy, seed=seed, device=str(dev),
               rate=cell.spec["arrival_rate"], reduced=list(cell.reduced),
               launches=launches)
    res["setup"] = {
        "build_s": {"value": build_s, "n": 1},
        "setup_s": {"value": setup_s, "n": 1},
        "peak_device_mem_gb": {"value": peak, "n": 1},
        "calibrated_prefill_tok_s": {"value": warm["prefill_rate"], "n": 1},
        "warm_chunk_prefill_tok_s": {"value": warm["chunk_tok_s"], "n": 1},
        "decode_step_b1_s": {"value": warm["decode1_s"], "n": 1},
    }
    # correctness
    counts = all(len(s.meta.get("generated", [])) ==
                 sum(r.decode_tokens for r in s.rounds) for s in finished)
    rng = np.random.default_rng(seed)
    pool = sorted(s.sid for s in finished)
    n = min(RESCORE_SESSIONS, len(pool))
    pick = sorted(int(x) for x in rng.choice(pool, size=n, replace=False))
    rs = rescore(cfg, params, spans, pick, chunk=cell.token_budget, dev=dev)
    # on the card the sessions must have gone through both paged kernels
    # (the wrappers count launches on CUDA tensors only)
    kernels = dev.type != "cuda" or all(launches[k] > 0 for k in MAIN_PATH)
    res["checks"] = {"decode_counts": counts, "invariants": invariants,
                     "main_path_launched": kernels, "rescore": rs,
                     "tau_z": TAU_Z}
    res["correct"] = bool(counts and invariants and kernels and rs["ok"])
    if traced:
        res["layers"] = _layers(sessions, eng, bus, stats, spans, tracer,
                                prof, launches)
    return res


def e2e_metrics(cell: Cell, sessions, finished, wall: float, eng: Engine,
             bus: EventBus, late: List[float]) -> dict:
    """The end-to-end metrics of one run (tracing off): ``wall`` is the
    run's length (on the simulator its horizon), ``late`` how late each
    arrival was submitted."""
    n = len(sessions)
    done = {s.sid for s in finished}
    good = [s for s in finished if s.e2e_latency <= ALPHA * s.ideal_time]
    out_tokens = sum(len(s.meta.get("generated", [])) for s in sessions)
    # round 0's first token from when the session was due (open loop:
    # admission waits included; Session.ttfts[0] starts at admission)
    first: Dict[int, float] = {}
    for e in bus.of_kind(ev.GPU_FIRST_TOKEN):
        if e.data["round"] == 0:
            first.setdefault(e.sid, e.t)
    by_arrival = sorted(sessions, key=lambda s: s.arrival_time)
    ttft0 = [first[s.sid] - s.arrival_time if s.sid in first else math.inf
             for s in by_arrival]
    e2e = {
        "ttft_resumed_s": summary(t for s in sessions for t in s.ttfts[1:]),
        "ttft_round0_s": summary(t for t in ttft0 if t < math.inf),
        "itl_s": summary(_itl(bus)),
        "session_e2e_s": summary(s.e2e_latency for s in finished),
        "slowdown": summary(s.e2e_latency / s.ideal_time for s in finished),
        "goodput_frac": {"value": len(good) / n, "n": n},
        "goodput_sessions_per_s": {"value": len(good) / wall, "n": n},
        "output_tokens_per_s": {"value": out_tokens / wall, "n": out_tokens},
        "failed_frac": {"value": sum(s.sid not in done for s in sessions) / n,
                        "n": n},
        "submit_late_s": summary(late),
        "ideal_measured_s": summary(s.ideal_time for s in sessions),
        "ideal_modelled_s": summary(s.meta["ideal_modelled_s"]
                                    for s in sessions),
    }
    return {"e2e": e2e, "wall_s": wall, "ttft0_by_arrival_s": ttft0,
            "attempted": n, "finished": len(finished)}


def _layers(sessions, eng: Engine, bus: EventBus, stats: dict,
            spans: _Spans, tracer, prof, launches) -> dict:
    """The per-layer metrics of the traced run."""
    prompt = sum(s.total_prompt_tokens for s in sessions)
    retention: Dict[str, int] = {}
    for e in bus.of_kind(ev.RETENTION):
        retention[e.data["action"]] = retention.get(e.data["action"], 0) + 1
    start: Dict[tuple, float] = {}
    tool_s, queue = [], []
    for e in bus.log:
        if e.kind == ev.TOOL_START:
            start[e.sid] = e.t
            queue.append(e.data.get("queue_wait", 0.0))
        elif e.kind == ev.TOOL_END and e.sid in start:
            tool_s.append(e.t - start.pop(e.sid))
    agg = tracer.aggregate()
    pool = eng.cpu_pool.stats()
    window = prof.read() if prof is not None else {"busy_frac": None}
    one = lambda v, n=1: {"value": v, "n": n}  # noqa: E731
    return {
        "mixed_iteration_s": summary(spans.iter_s),
        "mixed_s": one(stats["mixed_s"], stats["mixed_calls"]),
        "swap_out_s": one(stats["swap_out_s"], stats["batches"]),
        "swap_in_s": one(stats["swap_in_s"], stats["batches"]),
        "cow_s": one(stats["cow_s"], stats["batches"]),
        "device_busy_frac": one(window["busy_frac"],
                                PROFILE_TICKS if prof else 0),
        "profiler_stop_s": one(window.get("stop_s")),
        "prefix_hit_frac": one(eng.prefix_hit_tokens / max(prompt, 1),
                               prompt),
        "recomputed_tokens": one(sum(s.recomputed_tokens for s in sessions),
                                 len(sessions)),
        "retention": retention,
        "tool_s": summary(tool_s),
        "cpu_queue_wait_s": summary(queue),
        "cpu_queue_wait_total_s": one(pool["queue_wait_total_s"],
                                      len(queue)),
        "plane_frac": {k: round(v, 6) for k, v in
                       agg["bucket_frac"].items()},
        "traced_e2e_s": summary(s.e2e_latency for s in sessions
                                if s.finish_time >= 0),
        "launches": launches,
    }


UNITS = {"ttft_resumed_s": "s", "ttft_round0_s": "s", "itl_s": "s",
         "session_e2e_s": "s", "slowdown": "x ideal",
         "goodput_frac": "of sessions attempted",
         "goodput_sessions_per_s": "sessions/s",
         "output_tokens_per_s": "tokens/s",
         "failed_frac": "of sessions attempted", "submit_late_s": "s",
         "ideal_measured_s": "s", "ideal_modelled_s": "s",
         "build_s": "s", "setup_s": "s", "peak_device_mem_gb": "GB",
         "calibrated_prefill_tok_s": "tokens/s",
         "warm_chunk_prefill_tok_s": "tokens/s", "decode_step_b1_s": "s",
         "mixed_iteration_s": "s", "mixed_s": "s (calls)",
         "swap_out_s": "s (batches)", "swap_in_s": "s (batches)",
         "cow_s": "s (batches)", "device_busy_frac": "of the window (ticks)",
         "profiler_stop_s": "s (the stall stopping the profiler adds)",
         "prefix_hit_frac": "of prompt tokens",
         "recomputed_tokens": "tokens (sessions)", "tool_s": "s",
         "cpu_queue_wait_s": "s", "cpu_queue_wait_total_s": "s (tools)",
         "traced_e2e_s": "s"}


def report(res: dict, say: Callable[[str], None] = print) -> None:
    """Print every metric by name with its unit and sample count."""
    say(f"[bench] cell {res['cell']} policy {res['policy']} seed "
        f"{res['seed']} rate {res['rate']:g} sessions/s device "
        f"{res['device']}; {res['finished']}/{res['attempted']} sessions "
        f"finished in {res['wall_s']:.3f} s; cuts of scale: "
        f"{'; '.join(res['reduced']) or 'none'}")
    for name, m in res["setup"].items():
        say(metric_line("setup", name, m, UNITS[name]))
    for name, m in res["e2e"].items():
        say(metric_line("metric", name, m, UNITS[name]))
    say(f"[metric] sustained: {sustained(res)} (rule: no failure, median "
        f"slowdown <= {ALPHA:g}, round-0 TTFT not growing over the "
        f"arrivals)")
    for name, m in res.get("layers", {}).items():
        if isinstance(m, dict) and ("median" in m or "value" in m):
            say(metric_line("layer", name, m, UNITS[name]))
        else:
            say(f"[layer] {name}: {json.dumps(m)}")
    say(f"[bench] launches: {json.dumps(res['launches'])}")
    rs = res["checks"]["rescore"]
    say(f"[check] decode counts {res['checks']['decode_counts']}; "
        f"invariants {res['checks']['invariants']}; both paged kernels "
        f"launched {res['checks']['main_path_launched']}; re-score of "
        f"sessions "
        f"{rs['sids']} ({rs['flash_launches']} flash_attention launches): "
        f"{rs['tokens']} served tokens, max gap "
        f"{rs['max_gap_z']:.4f} sd, p99 {rs['p99_gap_z']:.4f} sd "
        f"(tau {TAU_Z:g} sd): {rs['ok']}")
    say(f"[check] correct: {res['correct']}")


def _card(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return smi.splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", required=True, choices=sorted(CELLS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="mars")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traced", action="store_true",
                    help="the separate traced run: per-layer metrics")
    ap.add_argument("--rates", default=None,
                    help="comma-separated arrival rates (sessions/s) for "
                         "the sweep that fixes a cell's rate")
    ap.add_argument("--json", metavar="OUT", default=None)
    args = ap.parse_args(argv)
    dev = _device(args.device)
    cell = CELLS[args.cell]
    if dev.type == "cpu":
        cell = cpu_cell(cell)
    print(f"[bench] card: {_card(dev)}", flush=True)
    rates = ([float(r) for r in args.rates.split(",")] if args.rates
             else [cell.spec["arrival_rate"]])
    params = build_params(cell, seed=args.seed, device=dev)
    results = []
    for rate in rates:
        res = run(cut(cell, arrival_rate=rate), seed=args.seed,
                  policy=args.policy, device=dev, params=params,
                  traced=args.traced)
        report(res, say=lambda m: print(m, flush=True))
        res["sustained"] = sustained(res)
        results.append(res)
    if len(rates) > 1:
        for res in results:
            e = res["e2e"]
            print(f"[sweep] rate {res['rate']:g}: sustained "
                  f"{res['sustained']}, median slowdown "
                  f"{_fmt(e['slowdown']['median'])}, goodput_frac "
                  f"{e['goodput_frac']['value']:.4f}, failed_frac "
                  f"{e['failed_frac']['value']:.4f}, wall "
                  f"{res['wall_s']:.3f} s", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results if len(results) > 1 else results[0], f,
                      indent=1, default=str)
            f.write("\n")
    return 0 if all(r["correct"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
