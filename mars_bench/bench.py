"""One run of one cell: serve the cell's traffic through the program for a
lead-in and a fixed window, read every metric, check the outputs.

Everything that belongs to one configuration, one traffic mix or one
metric is a file the harness finds by the name ``BENCHMARK.json`` gives:
``configs/<config>.json`` (through the configuration's ``file``),
``arch/<arch>.py`` (through the configuration's ``"arch"``),
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.

The timed path is the program's live entry: ``engine.engine.run_live``
drives ``Engine.tick`` -> ``TorchBackend.run_batch`` ->
``_PagedLayout.run_mixed`` -> ``lm_mixed_paged`` under the traffic's
policy with the mixed scheduler and real tool threads. The benchmark
wraps three calls of its own around it: ``Engine.submit`` (lateness),
``Engine.tick`` (the profiler's start in the traced run, a host span) and
``run_mixed`` (a host span, and what each call fed and served); and it
subscribes to the engine's event bus, stamping each event with the host
clock.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mars_bench import arch, check, generator, trace, weights
from mars_bench.window import (Ev, Iter, Run, attempted_failed,
                               iters_in_window)

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
PAGE = 32                 # KV page = radix chunk = generator chunk


# ---------------------------------------------------------------------------
# the files of a cell
# ---------------------------------------------------------------------------

def load_benchmark(root: Path = REPO) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: Dict, workload: str, root: Path = REPO):
    """(cell entry, configuration numbers, traffic parameters). The
    configuration's architecture is looked up in ``root``'s tree."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = _json(root / conf["file"])
    cfg[arch.DIR] = str(root / HERE.name / "arch")
    return (cell, cfg,
            _json(root / HERE.name / "traffic" / f"{cell['traffic']}.json"))


def metric_names(bench: Dict, cell: str, trace_on: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    tracing, the per-layer ones with it; a metric with ``workloads``
    only in the cells it lists."""
    group = bench["per_layer"] if trace_on else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str, root: Path = REPO) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "mars_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(cfg: Dict):
    """The program's ``ModelConfig`` for a configuration file."""
    return arch.module(cfg).program_config(cfg)


# ---------------------------------------------------------------------------
# warm-up: every shape this cell's traffic gives the mixed iteration
# ---------------------------------------------------------------------------

def _scratch_iteration(backend, *, P: int, C: int, Np: int, B: int,
                       maxp: int, length: int = 1) -> None:
    """One ``lm_mixed_paged`` call of P packs of C tokens (tables Np wide)
    and B decode lanes of ``length`` keys (tables maxp wide), every table
    entry and write on the pool's scratch page: no real page is touched."""
    from repro_torch.models.transformer import lm_mixed_paged
    impl = backend._impl
    sc, page, t = impl.scratch, impl.page, impl._t
    i32 = np.int32
    length = min(length, maxp * page)
    p, d, impl.cache = lm_mixed_paged(
        backend.cfg, backend.params, impl.cache,
        t(np.zeros((P, 1, C), i32)),
        t(np.tile(np.arange(C, dtype=i32), (P, 1, 1))),
        t(np.full((P, Np), sc, i32)), t(np.full((P, C), sc, i32)),
        t(np.tile(np.arange(C, dtype=i32) % page, (P, 1))),
        t(np.full((P,), C, i32)), t(np.full((P,), C - 1, i32)),
        t(np.zeros((B,), i32)), t(np.full((B,), length - 1, i32)),
        t(np.full((B, maxp), sc, i32)), t(np.full((B,), length, i32)),
        t(np.full((B,), sc, i32)), t(np.full((B,), (length - 1) % page, i32)))
    p.cpu(), d.cpu()


def warm_up(backend, serving: Dict, max_ctx: int) -> None:
    """Each pack width the token budget allows and each lane count up to
    ``max_decode_batch``, at the widest tables the traffic's longest
    context needs, then one full iteration (packs and lanes together)."""
    from repro_torch.engine.torch_runner import _bucket
    budget, lanes = serving["token_budget"], serving["max_decode_batch"]
    Np = _bucket(-(-(max_ctx + budget) // PAGE) + 1, lo=2)
    maxp = _bucket(-(-max_ctx // PAGE), lo=1)
    C = 32
    while C <= _bucket(budget):
        _scratch_iteration(backend, P=1, C=C, Np=Np, B=0, maxp=1)
        C *= 2
    B = 1
    while B <= _bucket(lanes, lo=1):
        _scratch_iteration(backend, P=0, C=1, Np=2, B=B, maxp=maxp,
                           length=max_ctx)
        B *= 2
    _scratch_iteration(backend, P=2, C=_bucket(budget), Np=Np,
                       B=_bucket(lanes, lo=1), maxp=maxp, length=max_ctx)


# ---------------------------------------------------------------------------
# the benchmark's spans and the event stamps
# ---------------------------------------------------------------------------

class Recorder:
    """Stamps bus events with the host clock, and wraps the program's
    ``submit``, ``tick`` and ``run_mixed``. ``profile_from``: in the traced
    run, the run-clock time after which the next tick starts the
    profiler."""

    def __init__(self, eng, backend, profile_from: Optional[float]):
        self.t_run = None
        self.events: List[Ev] = []
        self.iters: List[Iter] = []
        self.late: List[float] = []
        self.writes = check.Writes()
        self.prof = None
        self._profile_from = profile_from
        eng.bus.subscribe(None, self._on_event)
        self._wrap_submit(eng)
        self._wrap_tick(eng, backend.device)
        self._wrap_run_mixed(backend, eng.blocks)

    def now(self) -> float:
        return time.monotonic() - self.t_run

    def _on_event(self, e) -> None:
        if self.t_run is not None:
            t = e.t if e.kind == "submit" else self.now()
            self.events.append(Ev(e.kind, t, e.sid, e.data))

    def _wrap_submit(self, eng) -> None:
        inner = eng.submit

        def submit(s):
            self.late.append(self.now() - s.arrival_time)
            return inner(s)
        eng.submit = submit

    def _wrap_tick(self, eng, dev) -> None:
        inner = eng.tick

        def tick(now):
            if (self._profile_from is not None and self.prof is None
                    and self.now() >= self._profile_from):
                self.prof = _start_profiler(dev)
            if self.prof is None:
                return inner(now)
            with torch.profiler.record_function(trace.TICK):
                return inner(now)
        eng.tick = tick

    def _wrap_run_mixed(self, backend, pool) -> None:
        from repro_torch.engine.torch_runner import _bucket
        impl = backend._impl
        inner = impl.run_mixed

        def run_mixed(work):
            packs = [(s, s.resident_len, c,
                      s.resident_len + c >= s.prefill_target)
                     for s, c in work.prefills]
            lanes = [(s, s.resident_len, s.meta.get("next_token", 1))
                     for s, _g in work.decodes]
            t0 = self.now()
            if self.prof is None:
                inner(work)
            else:
                with torch.profiler.record_function(trace.ITER):
                    inner(work)
            t1 = self.now()
            C = _bucket(max((c for _s, _a, c, _f in packs), default=1))
            for s, start, c, final in packs:
                toks = s.meta["context_ids"][start:start + c]
                self.writes.pack(s, start, toks, C,
                                 s.meta["next_token"] if final else None)
            for s, pos, fed in lanes:
                self.writes.lane(s, pos, fed, s.meta["generated"][-1])
            self.iters.append(Iter(
                t0, t1, [(s.sid, a, c, C) for s, a, c, _f in packs],
                [(s.sid, pos) for s, pos, _f in lanes],
                profiled=self.prof is not None,
                pages=pool.physical_in_use))
        impl.run_mixed = run_mixed


def _start_profiler(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def warm_profiler(dev) -> None:
    """Start and stop the profiler once in set-up: its first start loads
    the tracing libraries (seconds), which must not land in the window."""
    prof = _start_profiler(dev)
    torch.ones(8, device=dev).sum().item()
    prof.stop()


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *,
             t_start: float, device="cuda", root: Path = REPO,
             shrink: Optional[Callable] = None, verify: bool = True,
             control: bool = False, keep: Optional[Dict] = None,
             say: Callable[[str], None] = print) -> Dict:
    """Serve ``workload`` once; returns the result line's object.
    ``shrink(cfg, traffic)`` returns changed copies (the tests' toy sizes,
    a sweep's rate). ``verify`` False skips the reference (a sweep);
    ``control`` also runs the fp8 control over the same streams (its gap
    statistics under ``"_control"``, the program's under ``"_gaps"``, and
    its verdict by the same rule as ``correct`` under
    ``"_control_correct"``);
    ``keep`` receives the ``Run``."""
    from repro_torch.engine.engine import Engine, EngineConfig, run_live
    from repro_torch.engine.tools import RealToolExecutor
    from repro_torch.engine.torch_runner import TorchBackend

    bench = load_benchmark(root)
    cell, cfg, traffic = cell_files(bench, workload, root)
    if shrink is not None:
        cfg, traffic = shrink(cfg, traffic)
    dev = torch.device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    serving = cfg["serving"]
    build_s = 0.0
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        t_build = time.monotonic()
        _build.build_all()            # a checkout's first run builds them
        build_s = time.monotonic() - t_build
        torch.cuda.reset_peak_memory_stats(dev)
    params = weights.make_params(cfg, seed, dtype=dtype, device=dev)
    sessions = generator.sessions(traffic, cfg["max_position_embeddings"])
    arrival = {s.sid: s.arrival_time for s in sessions}
    rounds = {s.sid: [(r.new_input_tokens, r.decode_tokens)
                      for r in s.rounds] for s in sessions}
    max_ctx = max(s.total_prompt_tokens
                  + sum(r.decode_tokens for r in s.rounds) for s in sessions)
    backend = TorchBackend(model_config(cfg), params=params, layout="paged",
                           total_pages=serving["pool_pages"],
                           page_size=PAGE,
                           max_slots=serving["max_decode_batch"],
                           device=dev, dtype=dtype)
    tools = eng = None
    lead_in = float(traffic["lead_in_s"])
    w1 = lead_in + seconds
    try:
        warm_up(backend, serving, max_ctx)
        from repro_torch.core.events import EventBus
        bus = EventBus()
        tools = RealToolExecutor(cpu_slots=serving["cpu_slots"], bus=bus)
        eng = Engine(EngineConfig(
            total_kv_blocks=serving["pool_pages"], block_size=PAGE,
            token_budget=serving["token_budget"],
            max_decode_batch=serving["max_decode_batch"],
            scheduler=traffic["scheduler"], cpu_slots=serving["cpu_slots"],
            host_tier_blocks=serving["host_tier_blocks"]),
            traffic["policy"], backend, bus=bus, tool_exec=tools)
        if trace_on:
            warm_profiler(dev)
        rec = Recorder(eng, backend, max(lead_in, w1 - traffic["profile_s"])
                       if trace_on else None)
        sync(dev)
        setup_s = time.monotonic() - t_start
        rec.t_run = time.monotonic()
        run_live(eng, sessions, timeout=w1)
        sync(dev)
        wall = rec.now()
        profile = None
        if rec.prof is not None:
            rec.prof.stop()
            profile = trace.read_profile(rec.prof)
            rec.prof = None
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        try:
            eng.check_invariants()
            invariants = True
        except AssertionError as exc:
            say(f"[check] engine invariants broken: {exc}")
            invariants = False
    finally:
        if tools is not None:
            tools.shutdown()
        backend.close()
    backend._impl.cache = None              # the pool goes before the check
    del backend, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(seconds=seconds, w0=lead_in, w1=w1, setup_s=setup_s,
              events=rec.events, arrival=arrival, rounds=rounds,
              iters=rec.iters, cfg=cfg, traffic=traffic, profile=profile)
    attempted, failed = attempted_failed(run)
    lead = rec.late                         # the generator's lateness
    say(f"[run] {workload}: seed {seed}, lead-in {lead_in:g} s, window "
        f"{seconds:g} s, rate {traffic['arrival_rate']:g} sessions/s; "
        f"loop ended {wall:.3f} s after the first arrival; "
        f"{len(rec.iters)} mixed iterations; generator lateness median "
        f"{np.median(lead) if lead else float('nan'):.6f} s, max "
        f"{max(lead) if lead else float('nan'):.6f} s (n {len(lead)})")
    say(f"[run] peak_device_mem_gb {peak / 1e9:.4f}; setup_s {setup_s!r}, "
        f"of which the kernel build (compiles in a checkout's first run "
        f"only) {build_s!r}")
    say(_pool_line(run, serving["pool_pages"]))
    if keep is not None:
        keep["run"] = run

    metrics, counts = {}, {}
    for m in metric_names(bench, workload, trace_on):
        got = reader(m["name"], root)(run)
        if got is None or got[0] is None:
            say(f"[metric] {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": float(got[0]), "unit": m["unit"]}
        counts[m["name"]] = got[1]
        more = "".join(f", {k} {v!r}" for k, v in
                       (got[2] if len(got) > 2 else {}).items())
        say(f"[metric] {m['name']}: {got[0]!r} {m['unit']} (n {got[1]}"
            f"{more})")

    t_check = time.monotonic()
    ck = cfg["check"]
    sids = check.sample(rec.writes, seed, ck["sessions"] if verify else 0)
    cmp = check.compare(cfg, params, rec.writes, sids, control=control)
    say(f"[check] reference over sessions {sids}: {cmp['tokens']} served "
        f"tokens ({cmp['resumed_tokens']} in resumed rounds, "
        f"{cmp['attached_epochs']} streams with radix-attached prefixes), "
        f"{time.monotonic() - t_check:.3f} s")
    say("[check] " + " ".join(f"{k} {cmp[k]!r}" for k in check.stats([])))
    if cmp["moe_entries"]:
        say(f"[check] MoE routed entries in the sample {cmp['moe_entries']},"
            f" dropped by the capacity dispatch {cmp['moe_dropped']} "
            f"({cmp['moe_dropped'] / cmp['moe_entries']!r})")
    checks = {name: {"value": cmp[name], "limit": limit}
              for name, limit in ck["limits"].items()}
    checks.update(
        tokens_compared={"value": cmp["tokens"], "limit": 1},
        rounds_failed={"value": failed, "limit": 0},
        invariants_broken={"value": int(not invariants), "limit": 0})
    correct = check.passes(cmp, ck["limits"], cmp["tokens"], failed,
                           invariants)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": {
               "platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}}
    if profile is not None:
        busy = trace.busy_s(profile)
        out["device"].update(busy_s=busy,
                             window_s=profile.t1 - profile.t0)
        out["breakdown"] = trace.breakdown(profile)
    out["checks"] = checks
    # for the harness's own scripts, dropped from the printed line
    out["_counts"] = counts
    out["_gaps"] = {k: cmp[k] for k in check.stats([])}
    if control:
        out["_control"] = cmp["control"]
        out["_control_correct"] = check.passes(
            cmp["control"], ck["limits"], cmp["tokens"], failed, invariants)
    return out


POOL_EVENTS = ("pin", "unpin", "swap_out", "swap_in", "swap_abandon",
               "evict", "preempt", "reject")


def _pool_line(run: Run, total: int) -> str:
    """The KV pool's fullest moment in the window, and the window's
    retention and eviction events by kind."""
    peak = max((it.pages for it in iters_in_window(run)), default=0)
    kinds = {k: 0 for k in POOL_EVENTS}
    for e in run.events:
        if e.kind in kinds and run.inside(e.t):
            kinds[e.kind] += 1
    return (f"[run] KV pool: at most {peak} of {total} pages held by "
            f"sessions after a mixed iteration of the window "
            f"({peak / total!r}); window events "
            + ", ".join(f"{k} {n}" for k, n in kinds.items()))
