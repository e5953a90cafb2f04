"""Agentic workload generator — ILR-1..4 and S-ILR-1..3 regimes (paper §6.1).

A hybrid pool in the style of SWE-bench / GitTaskBench / Terminal-Bench /
RepoBench / ∞Bench: multi-round sessions whose *prompt footprint* grows
monotonically across regimes (mean request-level prompt volume 125K -> 167K ->
220K -> 263K tokens) while ideal isolated execution time stays in the same
broad range (the controlled progression is context size, not task length).

Each session: a large first-round context (repository/task state) followed by
rounds of tool-output appends + decodes + tool executions drawn from four
tool kinds with distinct duration distributions.

**Session families** (``n_families > 0``): sessions are grouped into
families sharing a repository context — the dominant real-world structure of
ILR workloads (many agents on one repo). Each member's round-0 context is
``family shared prefix + member-unique tail``; a ``dup_frac`` slice of
members duplicates the family's canonical round-0 context outright (task
retries). Sessions carry ``meta["prefix_hashes"]`` — (chunk key, n_tokens)
pairs at KV-block granularity — which the engine's radix index matches so
family members attach to already-built physical KV blocks instead of
recomputing the shared prefix.
"""
from __future__ import annotations

import math
from dataclasses import astuple, dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.session import Round, Session, make_session
from repro_torch.kvcache.radix import chunk_key_digest
from repro_torch.models import perf_model as pm
from repro_torch.models.config import ModelConfig

# regime -> mean total prompt tokens per session
ILR_MEAN_PROMPT = {
    "ILR-1": 125_000, "ILR-2": 167_000, "ILR-3": 220_000, "ILR-4": 263_000,
    # GPT-OSS regimes: same methodology, restricted upper bound (131K ctx)
    "S-ILR1": 45_000, "S-ILR2": 70_000, "S-ILR3": 95_000,
}

# kind: (p_short, short_mean_s, short_sigma, long_mean_s, long_sigma).
# Durations are *bimodal mixtures* — a terminal command is an `ls` or a
# 5-minute build; a test run is one unit test or the whole suite. This is the
# unpredictability the paper blames for one-shot tool-time heuristics
# misfiring (per-kind EMA is a poor predictor of a bimodal draw). Calibrated
# so ideal session times land in Fig. 6's range (~400-2000 s, tool-dominated).
TOOL_KINDS = {
    "terminal": (0.70, 3.0, 0.6, 90.0, 0.8),
    "file_editor": (0.90, 2.5, 0.5, 30.0, 0.7),
    "task_tracker": (0.95, 1.5, 0.5, 15.0, 0.6),
    "test_runner": (0.45, 15.0, 0.7, 300.0, 0.8),
}

# Long-idle kinds (opt-in via ``WorkloadSpec.tool_mix`` — NOT part of the
# default draw, which must stay byte-stable for seeded baselines): CI
# pipelines and human-in-the-loop waits, the heavy-tailed multi-minute idle
# windows where host DRAM fills with parked KV and the NVMe cold tier pays
# for itself (Astraea's state-aware scheduling observes the same structure).
LONG_TOOL_KINDS = {
    "ci_runner": (0.15, 45.0, 0.6, 600.0, 0.7),
    "human_review": (0.10, 90.0, 0.8, 1500.0, 0.9),
}

ALL_TOOL_KINDS = {**TOOL_KINDS, **LONG_TOOL_KINDS}

# CPU-heavy mix (opt-in via ``WorkloadSpec.tool_mix``): the tool-dominated
# agentic profile where host cores, not the GPU, become the bottleneck —
# builds and test suites (test_runner) plus dense shell activity (terminal)
# with little of the near-free bookkeeping kinds. The cpu_contention
# benchmark drives the shared core pool into queueing with this mix; the
# default uniform draw stays untouched (seeded baselines are byte-stable).
TOOL_HEAVY_MIX = {
    "test_runner": 4.0,
    "terminal": 3.0,
    "file_editor": 1.0,
    "task_tracker": 0.5,
}


@dataclass
class WorkloadSpec:
    regime: str = "ILR-1"
    arrival_rate: float = 0.2          # requests / second (Poisson)
    n_sessions: int = 48
    seed: int = 0
    rounds_lo: int = 3
    rounds_hi: int = 9
    decode_mean: int = 220             # output tokens per round
    slo_alpha: float = 3.0
    max_context: Optional[int] = None  # hard cap (model context limit)
    first_round_frac: float = 0.55     # share of prompt volume in round 1
    tool_time_scale: float = 1.0
    # shared-prefix session families (0 = legacy independent sessions)
    n_families: int = 0
    shared_frac: float = 0.7           # family-shared share of round-0 ctx
    dup_frac: float = 0.1              # P(member duplicates canonical round 0)
    chunk_tokens: int = 32             # prefix-hash granularity (= block size)
    # tool-kind mix: {kind: weight} over ALL_TOOL_KINDS (long-idle kinds
    # included). None keeps the legacy uniform draw over TOOL_KINDS —
    # byte-identical RNG consumption for existing seeded workloads.
    tool_mix: Optional[Dict[str, float]] = None
    # SLO class name stamped onto session.meta["slo_class"] (declared in
    # repro.obs.slo.DEFAULT_SLO_CLASSES or supplied to the SloTracker).
    # None leaves sessions in the tracker's default class; no RNG draws,
    # so seeded workloads stay byte-identical.
    slo_class: Optional[str] = None


def _lognormal(rng, mean: float, sigma: float) -> float:
    mu = math.log(mean) - sigma ** 2 / 2
    return float(rng.lognormal(mu, sigma))


def _chunk_keys(wl, fid: int, useed, shared_len: int, total_len: int,
                chunk: int) -> List:
    """(key, n_tokens) per consecutive token chunk of a round-0 stream.
    Chunks fully inside the family-shared region key on the family; any
    chunk touching member-unique tokens keys on ``useed`` — identical
    streams therefore produce identical key sequences, and the boundary
    chunk never false-matches across members. ``wl`` is the full workload
    spec identity: family ids restart at 0 in every generate() call, so
    sessions from two different workloads fed to one engine must not
    false-match each other's radix blocks."""
    out = []
    pos, i = 0, 0
    while pos < total_len:
        n = min(chunk, total_len - pos)
        key = (("fam", wl, fid, i) if pos + n <= shared_len
               else ("u", wl, useed, i))
        out.append((key, n))
        pos += n
        i += 1
    return out


def generate(spec: WorkloadSpec, cfg: ModelConfig, hw: pm.HardwareSpec,
             tp: int = 1) -> List[Session]:
    rng = np.random.default_rng(spec.seed)
    # workload identity baked into prefix-hash keys; dict fields flatten to
    # sorted item tuples so the identity stays hashable
    wl = tuple(tuple(sorted(x.items())) if isinstance(x, dict) else x
               for x in astuple(spec))
    mix_kinds = mix_probs = None
    if spec.tool_mix:
        unknown = set(spec.tool_mix) - set(ALL_TOOL_KINDS)
        assert not unknown, f"unknown tool kinds in tool_mix: {unknown}"
        assert all(w >= 0 for w in spec.tool_mix.values()), \
            f"negative tool_mix weights: {spec.tool_mix}"
        mix_kinds = sorted(spec.tool_mix)
        total_w = sum(spec.tool_mix[k] for k in mix_kinds)
        assert total_w > 0, f"tool_mix weights sum to zero: {spec.tool_mix}"
        mix_probs = [spec.tool_mix[k] / total_w for k in mix_kinds]
    mean_prompt = ILR_MEAN_PROMPT[spec.regime]
    sessions: List[Session] = []
    # family-level canonical draws: shared repository-context size and the
    # canonical round-0 length (first member + duplicates use it verbatim)
    fam_shared: Dict[int, int] = {}
    fam_canon_first: Dict[int, int] = {}
    t = 0.0
    for i in range(spec.n_sessions):
        t += rng.exponential(1.0 / spec.arrival_rate)
        total_prompt = _lognormal(rng, mean_prompt, 0.45)
        if spec.max_context:
            total_prompt = min(total_prompt, 0.85 * spec.max_context)
        total_prompt = max(2_000.0, total_prompt)
        n_rounds = int(rng.integers(spec.rounds_lo, spec.rounds_hi + 1))
        first = spec.first_round_frac * total_prompt
        fid = useed = None
        if spec.n_families > 0:
            fid = i % spec.n_families
            if fid not in fam_shared:           # first member: canonical
                fam_shared[fid] = max(spec.chunk_tokens,
                                      int(spec.shared_frac * first))
                fam_canon_first[fid] = max(1, int(first))
                first = fam_canon_first[fid]
                useed = ("c", fid)
            elif rng.random() < spec.dup_frac:  # task retry: exact duplicate
                first = fam_canon_first[fid]
                useed = ("c", fid)
            else:                               # shared prefix + unique tail
                first = max(fam_shared[fid] + spec.chunk_tokens, int(first))
                useed = i
        rest = max(0.0, total_prompt - first)
        if n_rounds > 1:
            w = rng.dirichlet(np.ones(n_rounds - 1) * 2.0)
            appends = [first] + list(rest * w)
        else:
            appends = [total_prompt]
        rounds: List[Round] = []
        for r in range(n_rounds):
            dec = int(np.clip(_lognormal(rng, spec.decode_mean, 0.6), 24, 1200))
            if r < n_rounds - 1:
                if mix_kinds is not None:
                    kind = str(rng.choice(mix_kinds, p=mix_probs))
                else:
                    kind = str(rng.choice(list(TOOL_KINDS)))
                p_short, m_s, sg_s, m_l, sg_l = ALL_TOOL_KINDS[kind]
                if rng.random() < p_short:
                    dur = _lognormal(rng, m_s, sg_s)
                else:
                    dur = _lognormal(rng, m_l, sg_l)
                dur *= spec.tool_time_scale
            else:
                kind, dur = None, 0.0
            rounds.append(Round(new_input_tokens=max(1, int(appends[r])),
                                decode_tokens=dec, tool_kind=kind,
                                tool_seconds=dur))
        ideal = pm.ideal_session_time(
            cfg, hw, [(r.new_input_tokens, r.decode_tokens, r.tool_seconds)
                      for r in rounds], tp)
        s = make_session(t, rounds, slo_alpha=spec.slo_alpha,
                         ideal_time=ideal)
        if spec.slo_class is not None:
            s.meta["slo_class"] = spec.slo_class
        if fid is not None:
            s.meta["family"] = fid
            s.meta["prefix_hashes"] = _chunk_keys(
                wl, fid, useed, fam_shared[fid],
                rounds[0].new_input_tokens, spec.chunk_tokens)
            # wire-format anchor (first chunk key, hashed once here): the
            # cluster router matches this against heartbeat radix digests
            # to pull family members toward their repository context's home
            s.meta["prefix_anchor"] = chunk_key_digest(
                s.meta["prefix_hashes"][0][0])
        sessions.append(s)
    return sessions


def describe(sessions: Sequence[Session]) -> Dict[str, float]:
    prompts = [s.total_prompt_tokens for s in sessions]
    ideals = [s.ideal_time for s in sessions]
    return {
        "n": len(sessions),
        "mean_prompt_tokens": float(np.mean(prompts)),
        "p90_prompt_tokens": float(np.percentile(prompts, 90)),
        "mean_ideal_s": float(np.mean(ideals)),
        "mean_rounds": float(np.mean([len(s.rounds) for s in sessions])),
    }
