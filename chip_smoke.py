"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device       requires CUDA; prints the card and its power limit
2. build        builds the Hopper kernels with nvcc (sm_90a), prints seconds
3. kernels      holds each kernel against its plain PyTorch version on the
                card: the sweeps of tests/test_kernels.py plus the
                main-path shapes, in float32 (atol 2e-5) and bfloat16
                (every attention kernel at 2e-2 times the output's largest
                magnitude, capped at 2e-2, the main-path errors logged
                beside it); fused pool writes must be bit-exact; flash
                rows that see no key are not compared. Decode also at
                lengths on the split edges and at maxp * page, a
                16,384-token lane beside short ones, G 8 at D 128, B 1,
                idle lanes (they output v_new), and poisoned: NaN at every
                pool position no lane may read, the fused slot included
                before the write. wkv6:
                test_wkv6_shapes at f32 atol 5e-4, strong decay at 1e-4
                plus 1e-4 of the largest output, T = 1, a strided layout,
                extreme decays (w = 1e-12, w per channel from {1e-12, 1},
                w = 1e-12 on 24 of every 32 steps, w = 1e-3: finite,
                5e-4), tails of the kernel's 32-step chunk, T from 2 to 32,
                B * H = 1, K 32 and 64 at both kernels (T = 1 and T >= 2),
                and with bf16 r/k/v and the model's decays the main-path
                prefill, a 64-token resume from its final state and a
                decode step from it, at 1e-5 of the largest output. Then
                the bf16 tensor-core paths of both prefill attention
                kernels at tile edges (Sq 1-200, Skv and
                kv_len off multiples of 64 and mid-page, windows starting
                mid-tile, G 1-8, D 32-128, page 8-32), softcapped scores
                in the cap's saturating range, and poisoned: NaN at every
                pool or slot position no row may see, held to the plain
                version on the clean inputs
4. model        llama3.2-1b .reduced(): lm_prefill_paged / lm_decode_paged /
                lm_mixed_paged; gemma2-27b .reduced(): lm_forward, two
                lm_step prefill chunks (the second ragged, past the window)
                and lm_decode over slots at different positions; rwkv6-1.6b
                .reduced(): rwkv_forward, rwkv_prefill, decode steps and a
                forward resumed from the carried state. float32, same
                weights, on the card (kernels) and on the CPU (plain
                versions): logits and non-scratch cache within 1e-4 (rwkv6:
                1e-4 times the largest magnitude, at least 1), next tokens
                equal. Then llama and gemma2 again in bfloat16, the serving
                dtype, at the serving head dims (64, 128): card with the
                kernels against card with the plain attention, within
                3e-2 times the largest magnitude (at least 1), next tokens
                equal wherever the logit error cannot explain a tie. On
                llama also lm_prefill_paged_gather (the flash_attention
                kernel through lm_step) against lm_prefill_paged (the
                paged_flash_attention kernel) on the card over
                tests/test_paged_runner.py's chunk sequence (a shared
                prefix page, a ragged final chunk): reduced in f32 within
                1e-4, full width in bf16 within 3e-2 of the largest
                magnitude; both kernels must launch
5. serve        TorchBackend with llama3.2-1b at full width in bf16 (paged
                layout) under Engine(scheduler="mixed", policy "mars") with
                real sleep tools: 8 sessions in two shared-prefix families,
                3 rounds; then the same with every tool yield forced to
                OFFLOAD. Kernel launch counters are zeroed just before and
                read just after. Then, with the same weights, three serves
                whose launches are zeroed before and read after each
                (both paged kernels must launch):
   serve-obs    the MARS run again with the whole obs stack on the bus
                (Tracer with a MetricsRegistry and the engine probes,
                DetectorSuite, SloTracker, FlightRecorder under build/):
                every session's critical-path buckets sum to its e2e
                within 1%, the SLO tracker scores every session (goodput
                logged), no incident, the dispatch probe shows mixed
                calls, the Perfetto export re-reads with one X slice per
                span carrying sid/plane/kind; the wall logged beside
                serve's MARS run
   serve-faults a FaultPlan: admission frozen from the start, then
                the first decoding session frozen, each window ending at
                its incident (capped at 20 s) under DetectorConfig(
                livelock_ticks=64, admission_stall_ticks=64): an
                admission_stall, a decode_livelock for the frozen sid, the
                flight-recorder bundle replayed by Tracer.replay, every
                session finished with its tokens, invariants
   serve-router two TorchBackend replicas (own weights, 1,024 pages each)
                behind ClusterRouter, heartbeats with the radix digest:
                siblings placed by their family's digest get radix hits;
                replica b crashes (no ticks or heartbeats) with a session
                in a tool, the router fails it after 1 s and re-places
                its sessions on a, which prefills them again; every
                session finishes with its tokens, invariants hold on both
                engines, HealthReport says critical (a dead replica)
6. timing       each kernel, its plain version and one PyTorch library call
                (SDPA; flex_attention, compiled, for the softcapped
                flash_attention; none computes wkv6) on the same main-path
                inputs (CUDA events, warmed), and the bound from bytes and
                operations; the paged kernels also carry their profiler
                device times, and the times of the attention kernels
                before their redesigns (from PERF.md) are logged. The two
                decode kernels run each call on the next of 6 tables over
                disjoint pages (~120 MB a rotation against the 50 MB L2),
                SDPA on as many dense copies (cold L2), and once more on
                one table (warm L2); then one 16,384-token lane beside SDPA
                over the same keys
7. profile      device time by kernel over one full-width mixed iteration,
                and paged_attention_fused's device time per call
8. serve-rwkv   rwkv6-1.6b at full width in bf16 through model_zoo: 8
                sessions of 1,024-token prompts in one prefill, 16 greedy
                decode steps, a 64-token tool output per session resumed
                from the carried state, 16 more decode steps; wkv6 must
                launch 24 x 34 times. Then, in f32 at B = 1: prefill(1,024)
                plus a 64-token resume against prefill(1,088), within
                1e-3 of the largest logit, same argmax
9. profile      device time by kernel over one full-width rwkv6 prefill
                (B 8, T 1,024) and one decode step: wkv6's share, idle share
10. serve-dense TorchBackend with gemma2-27b at full width in bf16 (dense
                slot layout, 4 slots of 6,144 tokens), same engine: 4
                sessions (two 4,608-token prompts, past the 4,096 window;
                two of 1,024), 3 rounds; then the same with every tool
                yield forced to OFFLOAD (whole-slot swaps). Launch counters
                zeroed after the backend is built (calibrate runs lm_step),
                read after both runs: flash_attention must launch 46 times
                per prefill call
11. profile     device time by kernel over one full-width dense prefill
                chunk (C = 512 at q_offset 4,096) and one dense decode step
                over 4 slots
12. train       the training path, after the card is freed, f32: one
                train loss and its gradient (remat; chunked CE on the LM
                families) of llama3.2-1b, gemma2-27b (S 128: window and
                softcap), granite-moe-3b-a800m and rwkv6-1.6b .reduced(),
                card (kernels forward, their autograd Functions' plain
                backward) against the CPU on the same weights and batch:
                loss within 1e-5 relative, every gradient leaf within 2e-5
                of its largest |CPU gradient| (rwkv6: 2e-4), the wq/wk/wv
                (rwkv6: r/k/v and decay) gradients nonzero, the kernel
                launched in the step; the grad guard (flash_attention
                attaches to autograd, paged_attention refuses); then
                launch.train.train on the card, each step's wall, tokens/s
                and peak memory logged: full-width llama3.2-1b, B 8 x
                S 1,024, 10 steps, remat and chunked CE (the mean loss of
                the last 3 steps below the first 3's), full-width
                rwkv6-1.6b (B 4 x T 512, 3 steps, wkv6 launched), one
                full-width bf16 llama step (matmul_f32's Function), and a
                reduced llama run of 8 steps against 4 + 4 resumed from its
                checkpoint under build/, loss for loss equal. After each
                full-width run, each kernel it launched is held against its
                plain version at the run's first call (layer 0 of the first
                batch): the output and the autograd Function's input
                gradients for a random cotangent. Its launches are logged
                apart

The MoE family (qwen3-coder-30b-a3b, the paper's model, and
granite-moe-3b-a800m) adds, in run order:

- kernels: the decode pair at Qwen3's G 8, D 128 over 8 lanes at
  1,090-1,377, and a bf16 paged_flash_attention pack (C 256 at q_offset
  1,024, Hq 32, Hkv 4, D 128);
- model-moe (after model): both MoE configs .reduced() through the paged
  calls of phase 4 and the dense-cache calls, f32, card vs CPU, every
  route and capacity slot equal; one full-width moe_ffn (E 128, K 8,
  D 2048, F 768, 256 tokens, f32) card vs CPU, routes equal, within 1e-4
  of the largest output; qwen3 at full width with 4 layers in bf16, the
  kernels against the plain attention on the card, twice: both sides
  routing freely (the re-routed tokens counted: bf16 noise flips
  near-ties, which cascade), then the kernel side pinned to the plain
  side's routes, every token's logits and pool slots at the bf16
  tolerance;
- timing: the paged pair's rows also carry a "qwen3" entry (G 8, D 128);
- serve-moe (after profile-rwkv): qwen3-coder-30b-a3b at full width in
  bf16 (61 GB of random weights from seed 0, 1,024 pages of 32), driven
  through ServingAPI over Engine(scheduler="mixed"): 8 jobs of 3 rounds
  in two families sharing a 1,024-token prefix, each later request under
  the same job_id, under MARS (every job's second round warm) and under
  forced OFFLOAD (a host swap-out); both paged kernels must launch; its
  launches are logged apart, the kernels JSON keeps the llama serve's;
- profile-moe: one full-width mixed iteration (a pack of C 256 plus 8
  lanes): wall vs device time, idle share, device time by MoE step and
  by paged kernel. Freed before serve-dense.

The zamba2 (Mamba2 + shared attention) and whisper (encoder-decoder)
families add, in run order:

- kernels: flash_attention in f32 and bf16 at whisper's non-causal
  shapes with Sq != Skv (B 2, H 6, D 64: 448, 4 and 1 rows over 1,500
  keys) and zamba2's MHA (G 1, H 32, D 64, Sq = Skv = 1,024, causal), on
  model-layout views whose K/V storage holds NaN past Skv;
- model-ssm (after model-moe): zamba2-1.2b and whisper-tiny .reduced(),
  f32, card (flash kernel) vs CPU on the same weights: forward, prefill
  and a decode step from the padded cache; logits and every cache field
  within 1e-4 of the largest magnitude, next tokens equal, the flash
  launches counted;
- timing: flash_attention at whisper's cross-attention (B 8, H 6, 448 x
  1,500, non-causal) and zamba2's shared block (B 8, H 32, T 1,024,
  causal): event and device times, the plain version, SDPA and the bound,
  logged apart from the kernels JSON;
- serve-zamba, profile-zamba, serve-whisper (after profile-rwkv):
  zamba2-1.2b at full width in bf16 (8 prompts of 1,024 in one prefill,
  flash_attention exactly 6 times, the cache padded to 1,056, 16 greedy
  decode steps); the profile of that prefill and of a decode step (the
  SSD scan's and the flash kernel's shares); whisper-tiny at full width
  in bf16 (B 8 x 1,500 frames, a 4-token prompt, flash_attention exactly
  12 times, greedy decode to 64 tokens in a self cache of 448); each then
  in f32 at B 1, prefill plus teacher-forced decode steps against one
  forward over the whole sequence, within 1e-3 of the largest logit;
- train: both .reduced() in the card-vs-CPU gradient check, then
  full-width zamba2-1.2b (B 4 x S 512) and whisper-tiny (B 8 x S 448), 3
  f32 steps each with remat, each run's first flash call held against its
  plain version.

The line before the last is the kernels JSON line; the last line is the
device JSON line. TF32 is off throughout (float32 parity).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import qwen3_coder_30b  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core.events import EventBus  # noqa: E402
from repro_torch.core.policies import KVAction  # noqa: E402
from repro_torch.core.session import Phase, Round, make_session  # noqa: E402
from repro_torch.distributed.router import (  # noqa: E402
    ClusterRouter, RouterConfig)
from repro_torch.engine.api import ChatRequest, ServingAPI  # noqa: E402
from repro_torch.engine.engine import Engine, EngineConfig, run_live  # noqa: E402
from repro_torch.engine.faults import Fault, FaultPlan  # noqa: E402
from repro_torch.engine.tools import RealToolExecutor  # noqa: E402
from repro_torch.engine.torch_runner import TorchBackend  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _FlashAttention, flash_attention)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    _split_plan, paged_attention, paged_attention_fused)
from repro_torch.kernels.paged_flash_attention import \
    paged_flash_attention  # noqa: E402
from repro_torch.kernels.wkv6 import _WKV6, wkv6  # noqa: E402
from repro_torch.kvcache.radix import estimate_digest_match  # noqa: E402
from repro_torch.distributed import steps as train_steps  # noqa: E402
from repro_torch.launch.serve import run_cluster_live  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    PLANES, DetectorConfig, DetectorSuite, FlightRecorder, HealthReport,
    MetricsRegistry, SloTracker, Tracer, bind_engine_probes,
    export_perfetto, load_events_jsonl)
from repro_torch.train.optimizer import init_opt  # noqa: E402
from repro_torch.models import mamba2, model_zoo, zamba2  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

F32_TOL, BF16_TOL, MODEL_TOL = 2e-5, 3e-2, 1e-4
BF16_MODEL_TOL = 3e-2            # tests/test_torch_model.py's bf16 layer tol
FLASH_BF16_TOL = 2e-2            # tests/test_kernels.py's own for flash attention
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
TF32_FLOPS = 495e12              # dense TF32 tensor-core peak (f32 work)
F32_FLOPS = 67e12                # f32 outside the tensor cores
WKV_F32_TOL, WKV_STRONG_TOL = 5e-4, 1e-4   # tests/test_kernels.py's own
WKV_REL_TOL = 1e-5               # x the largest |output|, main-path bf16
MOE_FFN_REL_TOL = 1e-4           # x the largest |output|, f32 moe_ffn
KERNELS = {
    "paged_attention_fused": dict(
        fn=paged_attention_fused,
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:143"),
    "paged_flash_attention": dict(
        fn=paged_flash_attention,
        source="src/repro_torch/kernels/csrc/paged_flash_attention.cu",
        replaces="src/repro/kernels/paged_flash_attention.py:101"),
    "paged_attention": dict(
        fn=paged_attention,
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:217"),
    "flash_attention": dict(
        fn=flash_attention,
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:116"),
    "wkv6": dict(
        fn=wkv6, source="src/repro_torch/kernels/csrc/wkv6.cu",
        replaces="src/repro/kernels/wkv6.py:70"),
}
# the times of the kernels before their redesigns (the two prefill
# kernels on the CUDA cores; the two decode kernels as one block per
# (lane, kv head), timed with warm L2; wkv6 as one block of K threads per
# (b, h) walking every step, its main-path prefill's profiler device
# time), copied from PERF.md's kernel
# table (this script's timing phase on an H100 80GB HBM3 at 700 W): logged
# beside the new times on a line of their own, never put in the kernels
# JSON, whose numbers are all measured in the run that prints them
EARLIER_MS = {"paged_attention_fused": 0.2499, "paged_attention": 0.2234,
              "paged_flash_attention": 0.4225, "wkv6": 0.7629,
              "flash_attention": {"local": 3.0971, "global": 3.4152}}
MAIN_PATH = ("paged_attention_fused", "paged_flash_attention")
DENSE_PATH = ("flash_attention",)
RWKV_PATH = ("wkv6",)
DEV = torch.device("cuda")
QWEN3 = qwen3_coder_30b.CONFIG   # the paper's model; no assigned arch


def _zero_launches() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


def _launch_counts() -> dict:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 3. kernel parity
# ---------------------------------------------------------------------------

class Errors:
    """Largest |kernel - plain| per (kernel, dtype); raises past tol."""

    def __init__(self):
        self.max = {}

    def check(self, name, dtype, got, want, tol, what=""):
        err = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
        key = (name, str(dtype).replace("torch.", ""))
        self.max[key] = max(self.max.get(key, 0.0), err)
        if not err <= tol:
            raise AssertionError(f"{name} {key[1]} {what}: max abs err "
                                 f"{err} > {tol}")
        return err

    def exact(self, name, got, want, what):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: pool write not exact")


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _decode_case(gen, B, Hq, Hkv, D, page, P, maxp, dtype, *, lengths=None):
    q = _randn(gen, (B, Hq, D), dtype)
    kp = _randn(gen, (P, page, Hkv, D), dtype)
    vp = _randn(gen, (P, page, Hkv, D), dtype)
    perm = torch.randperm(P, generator=gen, device=DEV)
    table = perm[:B * maxp].reshape(B, maxp).int().contiguous()
    if lengths is None:
        lengths = torch.randint(1, maxp * page + 1, (B,), generator=gen,
                                device=DEV)
    lengths = torch.as_tensor(lengths, device=DEV).int()
    return q, kp, vp, table, lengths


def _fused_slots(table, lengths, page):
    B = table.shape[0]
    rows = torch.arange(B, device=DEV)
    wp = table[rows, ((lengths - 1) // page).long()].int().contiguous()
    wo = ((lengths - 1) % page).int()
    return wp, wo


def _bits(t):
    """The tensor's bits, so that NaN compares equal to itself."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _poison_decode(pages, table, limit):
    """NaN at every pool position outside rows [0, limit[b]) of each lane's
    table: the pages of no table, the tails past each limit, and (fused,
    limit = length - 1) the slot the new token is written to."""
    page = pages.shape[1]
    seen = torch.zeros(pages.shape[:2], dtype=torch.bool, device=DEV)
    for b in range(table.shape[0]):
        t = torch.arange(max(int(limit[b]), 0), device=DEV)
        seen[table[b, t // page].long(), t % page] = True
    nan = torch.tensor(float("nan"), dtype=pages.dtype, device=DEV)
    return torch.where(seen[..., None, None], pages, nan)


def _check_decode(errs, gen, dtype, B, Hq, Hkv, D, page, P, maxp,
                  lengths=None, poison=False):
    """Both decode kernels against the plain version on the same inputs,
    within ``_attn_tol``; the fused pool writes bit-exact. With ``poison``
    the kernels see NaN at every pool position no lane may read (see
    ``_poison_decode``; the plain version on the clean inputs is the
    reference). Returns (err, tol) of the read-only and the fused call."""
    q, kp, vp, table, lengths = _decode_case(gen, B, Hq, Hkv, D, page, P,
                                             maxp, dtype, lengths=lengths)
    k_new = _randn(gen, (B, Hkv, D), dtype)
    v_new = _randn(gen, (B, Hkv, D), dtype)
    wp, wo = _fused_slots(table, lengths, page)
    slot = (wp.long(), wo.long())
    kw, vw = kp.clone(), vp.clone()
    kw[slot], vw[slot] = k_new, v_new
    what = (f"B={B} Hq={Hq} Hkv={Hkv} D={D} page={page} maxp={maxp}"
            + (" poisoned" if poison else ""))
    out = []
    for name, want in (
            ("paged_attention",
             ref.paged_attention_ref(q, kp, vp, table, lengths)),
            ("paged_attention_fused",
             ref.paged_attention_ref(q, kw, vw, table, lengths))):
        fused = name == "paged_attention_fused"
        limit = lengths - int(fused)
        k_in, v_in = ((_poison_decode(kp, table, limit),
                       _poison_decode(vp, table, limit)) if poison
                      else (kp.clone(), vp.clone()))
        if fused:
            k_want, v_want = k_in.clone(), v_in.clone()
            k_want[slot], v_want[slot] = k_new, v_new
            got, k2, v2 = paged_attention_fused(q, k_in, v_in, table,
                                                lengths, k_new, v_new, wp, wo)
            errs.exact(name, _bits(k2), _bits(k_want), what)
            errs.exact(name, _bits(v2), _bits(v_want), what)
        else:
            got = paged_attention(q, k_in, v_in, table, lengths)
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} {what}: non-finite output")
        tol = _attn_tol(dtype, want)
        out.append((errs.check(name, dtype, got, want, tol,
                               f"{what} tol={tol:.3e}"), tol))
    return out


def _check_idle_lanes(errs, gen, dtype):
    """Two live lanes next to idle lanes (length 1, all-scratch table, all
    writing scratch slot 0): live outputs right, idle ones v_new,
    non-scratch pages exact."""
    B, Hq, Hkv, D, page, P, maxp = 6, 32, 8, 64, 32, 65, 8
    scratch = P - 1
    q, kp, vp, _, _ = _decode_case(gen, B, Hq, Hkv, D, page, P, maxp, dtype)
    live = torch.randperm(scratch, generator=gen, device=DEV)[:2 * maxp]
    table = torch.full((B, maxp), scratch, device=DEV).int()
    table[:2] = live.reshape(2, maxp).int()
    lengths = torch.tensor([200, 57, 1, 1, 1, 1], device=DEV).int()
    k_new = _randn(gen, (B, Hkv, D), dtype)
    v_new = _randn(gen, (B, Hkv, D), dtype)
    wp, wo = _fused_slots(table, lengths, page)
    kw, vw = kp.clone(), vp.clone()
    kw[wp[:2].long(), wo[:2].long()] = k_new[:2]
    vw[wp[:2].long(), wo[:2].long()] = v_new[:2]
    want = ref.paged_attention_ref(q[:2], kw, vw, table[:2], lengths[:2])
    o, k2, v2 = paged_attention_fused(q, kp, vp, table, lengths, k_new,
                                      v_new, wp, wo)
    errs.check("paged_attention_fused", dtype, o[:2], want,
               _attn_tol(dtype, want), "idle lanes")
    idle = v_new[2:].repeat_interleave(Hq // Hkv, dim=1)
    errs.check("paged_attention_fused", dtype, o[2:], idle,
               _attn_tol(dtype, idle), "idle lanes output v_new")
    errs.exact("paged_attention_fused", k2[:scratch], kw[:scratch],
               "idle lanes")
    errs.exact("paged_attention_fused", v2[:scratch], vw[:scratch],
               "idle lanes")


def _prefill_case(gen, B, Hq, Hkv, D, page, P, Np, Sq, dtype, *,
                  kv_len=None, table_ids=None):
    q = _randn(gen, (B, Hq, Sq, D), dtype)
    kp = _randn(gen, (P, page, Hkv, D), dtype)
    vp = _randn(gen, (P, page, Hkv, D), dtype)
    hi = table_ids if table_ids is not None else min(P, 4)
    table = torch.randint(0, hi, (B, Np), generator=gen, device=DEV).int()
    if kv_len is None:
        kv_len = torch.randint(Sq, (Np - 1) * page + 1, (B,), generator=gen,
                               device=DEV)
    kv_len = torch.as_tensor(kv_len, device=DEV).int()
    q_offset = (kv_len - Sq).int()
    return q, kp, vp, table, kv_len, q_offset


def _check_prefill(errs, gen, dtype, B, Hq, Hkv, D, page, P, Np, Sq, **kw):
    args = _prefill_case(gen, B, Hq, Hkv, D, page, P, Np, Sq, dtype, **kw)
    want = ref.paged_flash_attention_ref(*args)
    tol = _attn_tol(dtype, want)
    what = (f"B={B} Hq={Hq} Hkv={Hkv} D={D} page={page} Np={Np} Sq={Sq} "
            f"tol={tol}")
    err = errs.check("paged_flash_attention", dtype,
                     paged_flash_attention(*args), want, tol, what)
    return err, tol


def _check_shared_prefix_rows(dtype, gen):
    B, Hq, Hkv, D, page, P, Np, Sq = 2, 4, 2, 64, 32, 8, 4, 32
    q0 = _randn(gen, (1, Hq, Sq, D), dtype)
    q = torch.cat([q0, q0])
    kp = _randn(gen, (P, page, Hkv, D), dtype)
    vp = _randn(gen, (P, page, Hkv, D), dtype)
    table = torch.tensor([[0, 1, 2, 3], [0, 1, 2, 4]], device=DEV).int()
    kv_len = torch.full((B,), 3 * page, device=DEV).int()
    out = paged_flash_attention(q, kp, vp, table, kv_len, kv_len - Sq)
    if not torch.equal(out[0], out[1]):
        raise AssertionError("shared-prefix rows differ")


def _seen_rows(Sq, Skv, *, causal=True, window=None, q_offset=0,
               softcap=None):
    """Rows that see at least one key (the rest are finite, not compared:
    the TPU kernel gives them the mean of V, this one zero)."""
    q_pos = q_offset + torch.arange(Sq, device=DEV)
    lo = (q_pos - window + 1).clamp(min=0) if window else \
        torch.zeros_like(q_pos)
    hi = torch.minimum(q_pos, torch.tensor(Skv - 1, device=DEV)) if causal \
        else torch.full_like(q_pos, Skv - 1)
    return lo <= hi


def _flash_inputs(gen, B, Hq, Hkv, Sq, Skv, D, dtype, *, model_layout=False,
                  q_scale=1.0):
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D); with ``model_layout`` they
    are the transposed views the dense path hands the kernel (a
    (B, Sq, Hq, D) query and a (B, Skv, Hkv, D) cache slot). The scores
    are about N(0, q_scale^2)."""
    if model_layout:
        q = _randn(gen, (B, Sq, Hq, D), torch.float32).transpose(1, 2)
        k = _randn(gen, (B, Skv, Hkv, D), dtype).transpose(1, 2)
        v = _randn(gen, (B, Skv, Hkv, D), dtype).transpose(1, 2)
    else:
        q = _randn(gen, (B, Hq, Sq, D), torch.float32)
        k = _randn(gen, (B, Hkv, Skv, D), dtype)
        v = _randn(gen, (B, Hkv, Skv, D), dtype)
    return (q * q_scale).to(dtype), k, v


def _attn_tol(dtype, want):
    """Every attention kernel (dense and paged flash, paged decode). f32:
    2e-5 absolute. bf16: 2e-2, the JAX flash test's own tolerance, but
    relative to the output's scale, capped at 2e-2: at the main-path shapes
    the outputs (softmax averages over hundreds to thousands of keys) are
    themselves a few 1e-2, so an absolute 2e-2 (or the decode sweeps' old
    3e-2) would pass an output that merely has their magnitude."""
    if dtype == torch.float32:
        return F32_TOL
    return FLASH_BF16_TOL * min(1.0, want.float().abs().max().item())


def _check_flash(errs, gen, dtype, B, Hq, Hkv, Sq, Skv, D, *,
                 model_layout=False, q_scale=1.0, **kw):
    q, k, v = _flash_inputs(gen, B, Hq, Hkv, Sq, Skv, D, dtype,
                            model_layout=model_layout, q_scale=q_scale)
    got = flash_attention(q, k, v, **kw)
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"flash_attention: non-finite output {kw}")
    seen = _seen_rows(Sq, Skv, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)[:, :, seen]
    tol = _attn_tol(dtype, want)
    what = (f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D} {kw} "
            f"q_scale={q_scale} tol={tol}")
    err = errs.check("flash_attention", dtype, got[:, :, seen], want, tol,
                     what)
    return err, tol


# (B, Hq, Hkv, Sq, Skv, D) of test_flash_attention_shapes, causal at
# q_offset Skv - Sq
FLASH_SHAPES = [(2, 4, 2, 128, 128, 64), (1, 8, 8, 256, 256, 64),
                (1, 8, 2, 64, 192, 128), (2, 2, 1, 128, 128, 128)]
# the dense path's chunk: Hq 32, Hkv 16, D 128, C 512 at q_offset 4,096
# over a 6,144-token slot; window 4,096 (local layers) or none (global)
GEMMA2_CHUNK = dict(B=1, Hq=32, Hkv=16, Sq=512, Skv=6144, D=128)
GEMMA2_OFFSET, GEMMA2_WINDOW, GEMMA2_SOFTCAP = 4096, 4096, 50.0


def _flash_sweeps(errs, gen, dtype):
    for B, Hq, Hkv, Sq, Skv, D in FLASH_SHAPES:
        _check_flash(errs, gen, dtype, B, Hq, Hkv, Sq, Skv, D,
                     causal=True, q_offset=Skv - Sq)
    # test_flash_attention_masking_variants
    for window, softcap, causal in ((64, None, True), (None, 30.0, True),
                                    (32, 50.0, True), (None, None, False)):
        _check_flash(errs, gen, dtype, 1, 4, 2, 128, 128, 64,
                     causal=causal, window=window, softcap=softcap)
    # test_flash_attention_ragged_q
    for Sq in (100, 65, 1):
        _check_flash(errs, gen, dtype, 1, 4, 2, Sq, 128, 64,
                     causal=True, q_offset=128 - Sq)
    # a chunk whose padded rows run past the cache's end, and gemma2's
    # reduced shapes (D 32, window 64)
    _check_flash(errs, gen, dtype, 1, 4, 2, 64, 100, 64,
                 model_layout=True, q_offset=80, window=64, softcap=50.0)
    _check_flash(errs, gen, dtype, 1, 4, 2, 32, 160, 32,
                 model_layout=True, q_offset=84, window=64, softcap=50.0)
    for window in (GEMMA2_WINDOW, None):
        err, tol = _check_flash(errs, gen, dtype, *GEMMA2_CHUNK.values(),
                                model_layout=True, q_offset=GEMMA2_OFFSET,
                                window=window, softcap=GEMMA2_SOFTCAP)
        log(f"[kernels] flash_attention {str(dtype)[6:]} main-path chunk, "
            f"window {window}: max abs err {err:.3e} (tol {tol:.3e})")
    for case in SSM_FLASH_CASES:
        _check_flash_tail(errs, gen, dtype, *case)


# whisper's non-causal shapes (the cross-attention of the decoder's 448
# rows, of a 4-token prompt and of a decode row over 1,500 encoder frames)
# and zamba2's shared block (MHA, G 1, causal): (B, Hq, Hkv, Sq, Skv, D,
# causal)
SSM_FLASH_CASES = [(2, 6, 6, 448, 1500, 64, False),
                   (2, 6, 6, 4, 1500, 64, False),
                   (2, 6, 6, 1, 1500, 64, False),
                   (2, 32, 32, 1024, 1024, 64, True)]


def _check_flash_tail(errs, gen, dtype, B, Hq, Hkv, Sq, Skv, D, causal):
    """flash_attention on model-layout views (a (B, Sq, Hq, D) query, a
    (B, Skv, Hkv, D) K/V) whose K/V storage runs 64 positions past Skv
    with NaN there, where no row may look (1,500 ends mid-tile). Held
    against the plain version on the same views."""
    q = _randn(gen, (B, Sq, Hq, D), dtype).transpose(1, 2)
    k, v = (_randn(gen, (B, Skv + 64, Hkv, D), dtype) for _ in range(2))
    for t in (k, v):
        t[:, Skv:] = float("nan")
    k, v = (t[:, :Skv].transpose(1, 2) for t in (k, v))
    got = flash_attention(q, k, v, causal=causal)
    what = (f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D} "
            f"causal={causal}, NaN past Skv")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"flash_attention {what}: non-finite output")
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    tol = _attn_tol(dtype, want)
    err = errs.check("flash_attention", dtype, got, want, tol, what)
    log(f"[kernels] flash_attention {str(dtype)[6:]} {what}: max abs err "
        f"{err:.3e} (tol {tol:.3e})")


# (B, T, H, K, chunk) of test_wkv6_shapes
WKV_SHAPES = [(2, 64, 2, 32, 32), (1, 128, 4, 64, 32), (2, 96, 1, 64, 16),
              (1, 32, 2, 32, 8)]
# the main path: 8 sessions' 1,024-token prompts at rwkv6-1.6b's full
# width (H 32 = 2,048 / 64), and one decode step of those sessions
WKV_PREFILL = dict(B=8, T=1024, H=32, K=64)
WKV_DECODE = dict(B=8, T=1, H=32, K=64)


def _wkv_inputs(gen, B, T, H, K, dtype, *, model_like=False):
    """r/k/v in ``dtype``, w/u/state in f32. The test distributions
    (tests/test_kernels.py), or with ``model_like`` those the full-width
    model's init gives the recurrence: r/k/v ~ N(0, 1), decays
    exp(-exp(-6 + 0.6 N)) (about 0.9975, a long memory)."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    scale = 1.0 if model_like else 0.5
    r, k, v = (rn(B, T, H, K).mul_(scale).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rn(B, T, H, K) * 0.6 - 6.0) if model_like
                  else -torch.exp(rn(B, T, H, K) * 0.5 - 1.0))
    return r, k, v, w, rn(H, K) * 0.3, rn(B, H, K, K) * 0.1


def _check_wkv(errs, args, chunk, tol, what, *, rtol=0.0):
    """Kernel against plain version; returns the kernel's (o, state)."""
    o, sT = wkv6(*args, chunk=chunk)
    want_o, want_s = ref.wkv6_ref(*args)
    if not (torch.isfinite(o).all() and torch.isfinite(sT).all()):
        raise AssertionError(f"wkv6 {what}: non-finite output")
    dtype = args[0].dtype
    for got, want, part in ((o, want_o, "o"), (sT, want_s, "state")):
        t = tol + rtol * want.abs().max().item()
        errs.check("wkv6", dtype, got, want, t, f"{what} {part} tol={t:.3e}")
    return o, sT


def _wkv_extreme(gen, B, T, H, K, kind):
    """Test-distribution inputs (tests/test_kernels.py) with an extreme
    decay: w = 1e-12 everywhere, w drawn per channel from {1e-12, 1}, w =
    1e-12 on the first 24 steps of every 32 and 1 after, or w = 1e-3
    (where the TPU kernel's half-chunk centring overflows)."""
    r, k, v, _, u, s0 = _wkv_inputs(gen, B, T, H, K, torch.float32)
    if kind == "channels":
        pick = torch.rand((1, 1, H, K), generator=gen, device=DEV) < 0.5
        w = torch.where(pick, 1e-12, 1.0).expand(B, T, H, K).contiguous()
    elif kind == "front":
        front = (torch.arange(T, device=DEV) % 32 < 24)[None, :, None, None]
        w = torch.where(front, 1e-12, 1.0).expand(B, T, H, K).contiguous()
    else:
        w = torch.full((B, T, H, K), float(kind), device=DEV)
    return r, k, v, w, u, s0


# (B, T, H, K, chunk), f32, test distributions: tails for the chunked
# kernel's internal chunk of 32 steps (and for a chunk of 64), T between 2
# and 32, the carried-state check's length 1,088, B * H = 1
WKV_EDGES = [(2, 96, 2, 64, 16), (1, 1056, 2, 64, 32), (2, 1088, 2, 64, 32),
             (2, 48, 3, 32, 16), (1, 80, 2, 64, 16), (1, 1040, 1, 32, 16),
             (2, 40, 2, 64, 8), (3, 2, 2, 64, 32), (2, 7, 3, 32, 32),
             (2, 17, 2, 64, 32), (1, 31, 2, 32, 32), (2, 32, 2, 64, 32),
             (1, 64, 1, 64, 32), (1, 64, 1, 32, 32), (1, 1, 1, 64, 32),
             (1, 1, 1, 32, 32), (5, 1, 3, 32, 32)]


def _wkv_sweeps(errs, gen):
    """wkv6 against its plain version: test_wkv6_shapes (f32, atol 5e-4),
    the strong-decay case (w = 0.25; 1e-4 plus 1e-4 of the largest output,
    the JAX test's rtol/atol), single decode steps, a strided layout,
    extreme decays (w = 1e-12, w per channel from {1e-12, 1}, w = 1e-12
    on the first 24 steps of every 32, w = 1e-3; finite and within 5e-4),
    tails of the internal chunk, T from 2 to 32, B * H = 1, K 32 and 64 at
    both kernels, and the main-path shapes with
    bf16 r/k/v and the model's decays: the prefill, a 64-token resume from
    its final state, and a decode step from that state. There both versions
    upcast the same bf16 values and differ only in the order of f32 sums,
    over a state that grows to ~60 and outputs of ~600; the tolerance is
    1e-5 of the largest output, since an absolute one would mean nothing at
    that scale."""
    f32 = torch.float32
    for B, T, H, K, chunk in WKV_SHAPES:
        _check_wkv(errs, _wkv_inputs(gen, B, T, H, K, f32), chunk,
                   WKV_F32_TOL, f"B={B} T={T} H={H} K={K} chunk={chunk}")
    B, T, H, K = 1, 64, 2, 32
    strong = (torch.full((B, T, H, K), 0.3, device=DEV),
              torch.full((B, T, H, K), 0.3, device=DEV),
              torch.ones((B, T, H, K), device=DEV),
              torch.full((B, T, H, K), 0.25, device=DEV),
              torch.zeros((H, K), device=DEV),
              torch.zeros((B, H, K, K), device=DEV))
    _check_wkv(errs, strong, 32, WKV_STRONG_TOL, "strong decay",
               rtol=WKV_STRONG_TOL)
    for K in (32, 64):
        _check_wkv(errs, _wkv_inputs(gen, 3, 1, 4, K, f32), 32, WKV_F32_TOL,
                   f"T=1 K={K}")
    # r/k/v/w as (B, H, T, K) tensors seen through (B, T, H, K) views
    r, k, v, w, u, s0 = _wkv_inputs(gen, 2, 64, 3, 64, f32)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (r, k, v, w)]
    _check_wkv(errs, (*views, u, s0), 32, WKV_F32_TOL, "strided")
    for kind in ("1e-12", "channels", "front", "1e-3"):
        for K in (32, 64):
            _check_wkv(errs, _wkv_extreme(gen, 2, 64, 2, K, kind), 32,
                       WKV_F32_TOL, f"extreme decay w={kind} K={K}")
    for B, T, H, K, chunk in WKV_EDGES:
        _check_wkv(errs, _wkv_inputs(gen, B, T, H, K, f32), chunk,
                   WKV_F32_TOL, f"edge B={B} T={T} H={H} K={K} chunk={chunk}")
    _check_wkv(errs, _wkv_inputs(gen, 2, 17, 2, 64, torch.bfloat16), 32,
               WKV_F32_TOL, "bf16 T=17")
    main = _wkv_inputs(gen, *WKV_PREFILL.values(), torch.bfloat16,
                       model_like=True)
    _, state = _check_wkv(errs, main, 32, 0.0, "main-path prefill",
                          rtol=WKV_REL_TOL)
    log(f"[kernels] wkv6 bf16 main-path prefill {WKV_PREFILL}: max abs err "
        f"{errs.max[('wkv6', 'bfloat16')]:.3e}")
    B, _, H, K = WKV_PREFILL.values()
    for T, what in ((64, "64-token resume"), (1, "main-path decode")):
        r, k, v, w, u, _ = _wkv_inputs(gen, B, T, H, K, torch.bfloat16,
                                       model_like=True)
        _check_wkv(errs, (r, k, v, w, main[4], state), 32, 0.0,
                   f"{what} from the prefill's state", rtol=WKV_REL_TOL)


# Tile-edge shapes for the tensor-core paths (64-row query blocks, 64-key
# tiles): the cases of tests/test_torch_flash.py's and
# tests/test_torch_kernels.py's tile-edge tests, where the plain versions
# are held to JAX's. Flash: (B, Hq, Hkv, Sq, Skv, D), kwargs.
FLASH_EDGE_CASES = [
    ((1, 2, 2, 1, 77, 64), dict(q_offset=76)),
    ((2, 4, 2, 15, 100, 32), dict(q_offset=85, window=40)),
    ((1, 8, 2, 17, 129, 128), dict(q_offset=112, softcap=30.0)),
    ((1, 8, 1, 63, 190, 64), dict(q_offset=127, window=100, softcap=50.0)),
    ((1, 4, 2, 65, 65, 128), dict(q_offset=0)),
    ((1, 4, 1, 200, 333, 64), dict(q_offset=133, window=77)),
    ((1, 2, 1, 65, 150, 32), dict(causal=False, window=50)),
    ((1, 4, 4, 17, 70, 64), dict(q_offset=60)),
]
# paged: (B, Hq, Hkv, D, page, P, Np, Sq), kv_len per row
PREFILL_EDGE_CASES = [
    ((2, 2, 2, 64, 8, 24, 10, 1), (73, 1)),
    ((2, 4, 2, 32, 16, 20, 6, 15), (90, 15)),
    ((1, 8, 2, 128, 32, 8, 5, 17), (147,)),
    ((2, 8, 1, 64, 8, 40, 12, 63), (91, 70)),
    ((1, 4, 2, 64, 16, 16, 10, 65), (150,)),
    ((1, 4, 1, 128, 32, 12, 9, 200), (263,)),
]


def _paged_edge(gen, dtype, shape, kv_len):
    """A prefill case with distinct pages per row (so a page that one row
    may not see is seen by no other row either)."""
    B, Hq, Hkv, D, page, P, Np, Sq = shape
    q = _randn(gen, (B, Hq, Sq, D), dtype)
    kp = _randn(gen, (P, page, Hkv, D), dtype)
    vp = _randn(gen, (P, page, Hkv, D), dtype)
    perm = torch.randperm(P, generator=gen, device=DEV)
    table = perm[:B * Np].reshape(B, Np).int().contiguous()
    kvl = torch.tensor(kv_len, device=DEV).int()
    return q, kp, vp, table, kvl, (kvl - Sq).int()


def _poison_pages(args):
    """NaN in every pool position that no row of the call may see: pages
    outside each row's visible range and the tail of its last page."""
    q, kp, vp, table, kvl, qo = args
    Sq, page = q.shape[2], kp.shape[1]
    seen = torch.zeros(kp.shape[:2], dtype=torch.bool, device=DEV)
    for b in range(table.shape[0]):
        end = min(int(kvl[b]), int(qo[b]) + Sq, table.shape[1] * page)
        t = torch.arange(end, device=DEV)
        seen[table[b, t // page].long(), t % page] = True
    nan = torch.tensor(float("nan"), dtype=kp.dtype, device=DEV)
    return (q, torch.where(seen[..., None, None], kp, nan),
            torch.where(seen[..., None, None], vp, nan), table, kvl, qo)


def _poison_slot(k, Sq, q_offset, window):
    """NaN at every slot position outside the keys the call's rows see."""
    Skv = k.shape[2]
    pos = torch.arange(Skv, device=DEV)
    lo = max(0, q_offset - window + 1) if window else 0
    hi = min(Skv, q_offset + Sq)
    seen = ((pos >= lo) & (pos < hi))[None, None, :, None]
    return torch.where(seen, k, torch.tensor(float("nan"), dtype=k.dtype,
                                             device=DEV))


def _edge_sweeps(errs, gen, dtype):
    """Tile-edge shapes for both attention kernels; softcapped scores that
    reach the cap's saturating range; then the poisoned cases: NaN
    wherever no row may look, held against the plain version on the
    unpoisoned inputs (a masked key weighs 0, but 0 * NaN is NaN)."""
    for n, (shape, kw) in enumerate(FLASH_EDGE_CASES):
        _check_flash(errs, gen, dtype, *shape, model_layout=n % 2 == 1, **kw)
    # scores about N(0, q_scale^2) against the cap: s / softcap about
    # N(0, 1) at the main-path chunk, N(0, 16) (deep in saturation) below
    for shape, q_scale, kw in (
            (tuple(GEMMA2_CHUNK.values()), GEMMA2_SOFTCAP,
             dict(q_offset=GEMMA2_OFFSET, window=GEMMA2_WINDOW,
                  softcap=GEMMA2_SOFTCAP)),
            ((1, 8, 2, 100, 300, 64), 120.0,
             dict(q_offset=200, window=64, softcap=30.0))):
        err, tol = _check_flash(errs, gen, dtype, *shape, model_layout=True,
                                q_scale=q_scale, **kw)
        log(f"[kernels] flash_attention {dtype} softcap {kw['softcap']} at "
            f"scores x{q_scale} (saturating) Sq={shape[3]} Skv={shape[4]} "
            f"D={shape[5]}: max abs err {err:.3e} (tol {tol:.3e})")
    for shape, kv_len in PREFILL_EDGE_CASES:
        args = _paged_edge(gen, dtype, shape, kv_len)
        want = ref.paged_flash_attention_ref(*args)
        errs.check("paged_flash_attention", dtype,
                   paged_flash_attention(*args), want,
                   _attn_tol(dtype, want), f"edge {shape} kv_len={kv_len}")
    for shape, kv_len in (((2, 8, 2, 64, 16, 40, 12, 65), (150, 97)),
                          ((1, 32, 8, 64, 32, 80, 66, 256), (1280,))):
        args = _paged_edge(gen, dtype, shape, kv_len)
        got = paged_flash_attention(*_poison_pages(args))
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"paged_flash_attention poisoned {shape}: "
                                 "non-finite output")
        want = ref.paged_flash_attention_ref(*args)
        tol = _attn_tol(dtype, want)
        err = errs.check("paged_flash_attention", dtype, got, want, tol,
                         f"poisoned {shape} kv_len={kv_len}")
        log(f"[kernels] paged_flash_attention {dtype} poisoned {shape} "
            f"kv_len={kv_len}: max abs err {err:.3e} (tol {tol:.3e})")
    for B, Hq, Hkv, Sq, Skv, D, q_offset, window in (
            (1, 4, 2, 100, 400, 64, 150, 70),
            (1, 8, 4, 65, 300, 128, 100, None),
            (1, 32, 16, 512, 6144, 128, GEMMA2_OFFSET, GEMMA2_WINDOW)):
        q, k, v = _flash_inputs(gen, B, Hq, Hkv, Sq, Skv, D, dtype,
                                model_layout=True)
        kw = dict(q_offset=q_offset, window=window, softcap=GEMMA2_SOFTCAP)
        got = flash_attention(q, _poison_slot(k, Sq, q_offset, window),
                              _poison_slot(v, Sq, q_offset, window), **kw)
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"flash_attention poisoned {q.shape}: "
                                 "non-finite output")
        want = ref.flash_attention_ref(q, k, v, **kw)
        errs.check("flash_attention", dtype, got, want,
                   _attn_tol(dtype, want), f"poisoned Sq={Sq} Skv={Skv} {kw}")


# (B, Hq, Hkv, D, page, P, maxp): the sweeps of tests/test_kernels.py, then
# G 8 at D 128, B 1 (at G 8 and at the main path's width) and D 32
DECODE_SWEEP = [(4, 8, 2, 64, 32, 64, 8), (2, 4, 4, 128, 16, 32, 4),
                (1, 16, 8, 64, 32, 16, 6), (3, 6, 2, 64, 8, 40, 10),
                (2, 4, 2, 64, 16, 16, 4), (2, 16, 2, 128, 32, 40, 8),
                (1, 8, 1, 128, 16, 40, 12), (1, 32, 8, 64, 32, 600, 64),
                (2, 8, 2, 32, 32, 16, 4)]
# the main path: Hq 32, Hkv 8, D 64, page 32, 8 lanes of up to 64 pages
DECODE_MAIN = (8, 32, 8, 64, 32, 600, 64)
# one 16,384-token lane (maxp 512) next to short ones
DECODE_LONG = ((4, 32, 8, 64, 32, 2100, 512), [16384, 5, 129, 1000])
# the MoE serve's decode: Qwen3-Coder's Hq 32, Hkv 4, D 128 (G 8), 8 lanes
DECODE_QWEN3 = (8, 32, 4, 128, 32, 600, 64)
MAIN_LENS = [1090, 1131, 1160, 1188, 1216, 1270, 1310, 1377]


def _decode_edges():
    """Main-path lengths at the split edges (k * split and k * split +- 1
    for the read-only limit, the length, and the fused one, length - 1)
    and at maxp * page."""
    B, _, Hkv, _, page, _, maxp = DECODE_MAIN
    pps, _ = _split_plan(B, Hkv, maxp, page)
    k = pps * page
    return [k - 1, k, k + 1, k + 2, 2 * k - 1, 2 * k + 1, 3 * k, maxp * page]


def _decode_sweeps(errs, gen, dtype):
    for shape in DECODE_SWEEP:
        _check_decode(errs, gen, dtype, *shape)
    ((e_ro, t_ro), (e_f, t_f)) = _check_decode(errs, gen, dtype, *DECODE_MAIN)
    log(f"[kernels] paged_attention {str(dtype)[6:]} main path: max abs err "
        f"{e_ro:.3e} (tol {t_ro:.3e}); fused {e_f:.3e} (tol {t_f:.3e})")
    _check_decode(errs, gen, dtype, *DECODE_MAIN,
                  lengths=[2048, 1, 33, 1024, 1500, 700, 64, 1999])
    ((e_ro, t_ro), (e_f, t_f)) = _check_decode(errs, gen, dtype,
                                               *DECODE_QWEN3,
                                               lengths=MAIN_LENS)
    log(f"[kernels] paged_attention {str(dtype)[6:]} Qwen3 (G 8, D 128) 8 "
        f"lanes at 1,090-1,377: max abs err {e_ro:.3e} (tol {t_ro:.3e}); "
        f"fused {e_f:.3e} (tol {t_f:.3e})")
    _check_decode(errs, gen, dtype, *DECODE_MAIN, lengths=_decode_edges())
    _check_decode(errs, gen, dtype, *DECODE_LONG[0], lengths=DECODE_LONG[1])
    for shape, lengths in ((DECODE_MAIN, [129, 1, 2048, 700, 128, 1377, 64,
                                          257]),
                           ((3, 6, 2, 64, 8, 40, 10), [80, 1, 33]),
                           DECODE_LONG):
        ((e_ro, t_ro), (e_f, t_f)) = _check_decode(
            errs, gen, dtype, *shape, lengths=lengths, poison=True)
        log(f"[kernels] paged_attention {str(dtype)[6:]} poisoned "
            f"B={shape[0]} G={shape[1] // shape[2]} page={shape[4]} "
            f"lengths={lengths}: max abs err {e_ro:.3e} (tol {t_ro:.3e}); "
            f"fused {e_f:.3e} (tol {t_f:.3e})")
    _check_idle_lanes(errs, gen, dtype)


def phase_kernels() -> Errors:
    errs = Errors()
    gen = torch.Generator(device=DEV).manual_seed(7)
    prefill_sweep = [(2, 4, 2, 64, 32, 8, 4, 64), (1, 8, 8, 64, 16, 6, 6, 64),
                     (2, 2, 1, 128, 32, 8, 4, 32),
                     (1, 4, 2, 64, 32, 8, 8, 96), (2, 4, 2, 64, 32, 8, 4, 33),
                     (2, 4, 2, 64, 32, 8, 4, 7), (1, 4, 2, 64, 32, 8, 4, 1),
                     (2, 4, 2, 32, 32, 8, 4, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        _decode_sweeps(errs, gen, dtype)
        for shape in prefill_sweep:
            _check_prefill(errs, gen, dtype, *shape)
        # main path: chunks up to the token budget over up to 2k context
        for C, kv in ((512, 2048), (256, 1280), (200, 1000), (32, 32)):
            err, ptol = _check_prefill(errs, gen, dtype, 1, 32, 8, 64, 32, 80,
                                       66, C, kv_len=[kv], table_ids=80)
            log(f"[kernels] paged_flash_attention {dtype} main path C={C} "
                f"kv_len={kv}: max abs err {err:.3e} (tol {ptol:.3e})")
        _check_shared_prefix_rows(dtype, gen)
        _flash_sweeps(errs, gen, dtype)
    # the MoE serve's pack: Qwen3-Coder's G 8 at D 128 on the tensor cores
    err, ptol = _check_prefill(errs, gen, torch.bfloat16, 1, 32, 4, 128, 32,
                               80, 66, 256, kv_len=[1280], table_ids=80)
    log(f"[kernels] paged_flash_attention bf16 Qwen3 (Hq 32, Hkv 4, D 128) "
        f"C=256 at q_offset 1,024: max abs err {err:.3e} (tol {ptol:.3e})")
    _edge_sweeps(errs, gen, torch.bfloat16)
    _wkv_sweeps(errs, gen)
    torch.cuda.synchronize()
    for (name, dt), err in sorted(errs.max.items()):
        log(f"[kernels] {name:22s} {dt:9s} max_abs_err={err:.3e}")
    return errs


# ---------------------------------------------------------------------------
# 4. model parity: card (kernels) vs CPU (plain versions) in float32; in
#    bfloat16, the serving dtype, card (kernels) vs card (plain attention)
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_device(tree):
    return _tree_map(lambda t: t.to(DEV), tree)


@contextlib.contextmanager
def _plain_attention():
    """The model's attention through the plain versions, on whatever
    device its tensors are: the reference side of the bf16 model phases.
    Patches the ``ops`` entry points the layers call; restored on exit."""
    from repro_torch.kernels import ops

    def decode(q, k_pages, v_pages, block_table, lengths, *, k_new=None,
               v_new=None, write_pages=None, write_offsets=None):
        if k_new is None:
            return ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                           lengths)
        slot = (write_pages.long(), write_offsets.long())
        k_pages.index_put_(slot, k_new)
        v_pages.index_put_(slot, v_new)
        return (ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                        lengths), k_pages, v_pages)

    saved = ops.attention, ops.prefill_attention, ops.decode_attention
    ops.attention = ref.flash_attention_ref
    ops.prefill_attention = ref.paged_flash_attention_ref
    ops.decode_attention = decode
    try:
        yield
    finally:
        ops.attention, ops.prefill_attention, ops.decode_attention = saved


@contextlib.contextmanager
def _routes(pin=None):
    """Records every ``moe_ffn`` call made inside, in call order, on the
    CPU: its own top-k ``idx`` (T, K) and the capacity slot ``pos`` and
    ``keep`` (T, K) it dispatched with.
    With ``pin`` (the records of another run of the same calls) each call
    routes to that run's experts instead of its own top-k, weighted by
    its own probabilities, so capacity ranks and drops follow the pinned
    run; the record still holds the call's own top-k. Wraps
    ``layers._route`` and ``layers._dispatch``, which ``moe_ffn`` looks
    up at call time; restored on exit."""
    from repro_torch.models import layers
    rec = []
    orig_route, orig_dispatch = layers._route, layers._dispatch

    def route(moe, logits):
        idx, w = orig_route(moe, logits)
        rec.append(dict(idx=idx.cpu()))
        if pin is not None:
            idx = pin[len(rec) - 1]["idx"].to(logits.device)
            w = torch.softmax(logits.float(), dim=-1).gather(-1, idx)
            w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)
        return idx, w

    def dispatch(x, idx, w, num_experts, capacity):
        buf, (flat_e, pos_c, keep) = orig_dispatch(x, idx, w, num_experts,
                                                   capacity)
        rec[-1].update(pos=pos_c.view(idx.shape).cpu(),
                       keep=keep.view(idx.shape).cpu())
        return buf, (flat_e, pos_c, keep)
    layers._route, layers._dispatch = route, dispatch
    try:
        yield rec
    finally:
        layers._route, layers._dispatch = orig_route, orig_dispatch


class _ModelParity:
    """The two sides of a model phase and their comparison. float32: the
    reference runs on the CPU (plain versions), the kernels on the card,
    within MODEL_TOL. bfloat16: both run on the card, the reference under
    _plain_attention, within BF16_MODEL_TOL times the reference's largest
    magnitude (at least 1); the reference side must launch no kernel and
    the kernel side must launch each of ``kernels``. Next tokens must be
    equal; in bfloat16 at each row whose reference top two logits differ
    by more than twice the row's largest logit error (a closer tie may
    break either way within it), the other rows counted as near ties.

    An MoE model (``n_layers`` given) also has its routes compared, one
    forward (``n_layers`` moe_ffn calls) after another, on each forward's
    real tokens (``real``: their count per forward; padded lanes and idle
    decode lanes come last and take no capacity slot from a real token).
    float32: expert indices and capacity slots must be equal. bfloat16:
    the attention kernels' rounding moves the router logits a little; at
    a near tie of the top-k that flips a route, which moves the token's
    output by O(1), then every later token that attends to it and every
    token whose capacity slot it takes. So with ``pin`` the kernel side
    routes to the reference's experts (``_routes``) and every token is
    compared; the tokens whose own top-k differs from the reference's are
    counted. Without ``pin`` (both sides free-running) the re-routed
    tokens are counted and nothing is compared."""

    def __init__(self, label, dtype, kernels, n_layers=0, pin=True):
        self.label, self.dtype, self.kernels = label, dtype, kernels
        self.bf16 = dtype == torch.bfloat16
        self.ref_dev = DEV if self.bf16 else torch.device("cpu")
        self.worst = 0.0
        self.launched = dict.fromkeys(kernels, 0)
        self.compared = self.ties = 0
        self.n_layers, self.pin = n_layers, pin
        self.tokens = self.flipped = self.pairs = self.pairs_flipped = 0

    def params(self, params):
        """(reference, kernel) copies of float32 ``params`` in the dtype."""
        return (_tree_map(lambda t: t.to(self.ref_dev, self.dtype), params),
                _tree_map(lambda t: t.to(DEV, self.dtype), params))

    def cache(self, kind, k0, v0):
        return (kind(k0.to(self.ref_dev, self.dtype, copy=True),
                     v0.to(self.ref_dev, self.dtype, copy=True)),
                kind(k0.to(DEV, self.dtype), v0.to(DEV, self.dtype)))

    def run(self, fn, ref_args, dev_args, real=None):
        """fn(*ref_args) as the reference, fn(*dev_args) with the kernels;
        ``real``: the real tokens of each forward (MoE routes)."""
        counts = [KERNELS[n]["fn"].launches for n in self.kernels]
        with _routes() as want_routes:
            if self.bf16:
                with _plain_attention():
                    want = fn(*ref_args)
                if [KERNELS[n]["fn"].launches for n in self.kernels] \
                        != counts:
                    raise AssertionError(f"{self.label}: the plain side "
                                         "launched a kernel")
            else:
                want = fn(*ref_args)
        pin = want_routes if self.bf16 and self.pin else None
        with _routes(pin) as got_routes:
            got = fn(*dev_args)
        for n, c in zip(self.kernels, counts):
            self.launched[n] += KERNELS[n]["fn"].launches - c
        if self.n_layers:
            self.routes(got_routes, want_routes, real,
                        getattr(fn, "__name__", "call"))
        return want, got

    def routes(self, got, want, real, what):
        L = self.n_layers
        if len(got) != len(want) or not got or len(got) % L:
            raise AssertionError(f"{self.label} {what}: {len(got)} vs "
                                 f"{len(want)} moe_ffn calls")
        for f, g0 in enumerate(range(0, len(got), L)):
            n = got[g0]["idx"].shape[0] if real is None else real[f]
            flipped = torch.zeros(n, dtype=torch.bool)
            for l in range(L):
                g, w = got[g0 + l], want[g0 + l]
                self.pairs += n
                if not self.bf16:
                    if not (torch.equal(g["idx"][:n], w["idx"][:n])
                            and torch.equal(g["pos"][:n], w["pos"][:n])):
                        bad = ((g["idx"][:n] != w["idx"][:n])
                               | (g["pos"][:n] != w["pos"][:n])).any(-1)
                        raise AssertionError(
                            f"{self.label} {what} forward {f} layer {l}: "
                            f"routes or capacity slots differ at tokens "
                            f"{bad.nonzero()[:8, 0].tolist()}")
                    continue
                flip = (g["idx"][:n].sort(-1).values
                        != w["idx"][:n].sort(-1).values).any(-1)
                self.pairs_flipped += int(flip.sum())
                flipped |= flip
            self.tokens += n
            self.flipped += int(flipped.sum())

    def tol(self, want):
        if not self.bf16:
            return MODEL_TOL
        return BF16_MODEL_TOL * max(1.0, want.float().abs().max().item())

    def agree(self, got, want, what):
        want = want.float().cpu()
        err = (got.float().cpu() - want).abs().max().item()
        tol = self.tol(want)
        self.worst = max(self.worst, err / tol)
        if not err <= tol:
            raise AssertionError(f"{self.label} {what}: max abs err {err} > "
                                 f"{tol}")

    def same(self, got, want, what):
        got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
        self.compared += want.numel()
        if got.tolist() != want.tolist():
            raise AssertionError(f"{self.label} {what}: next tokens differ: "
                                 f"{got} vs {want}")

    def same_next(self, got_logits, want_logits, what):
        got_logits = got_logits.float().cpu()
        want_logits = want_logits.float().cpu()
        got, want = (torch.argmax(got_logits, -1),
                     torch.argmax(want_logits, -1))
        if self.bf16:
            top = torch.topk(want_logits, 2, -1).values
            err = (got_logits - want_logits).abs().amax(-1)
            decided = top[..., 0] - top[..., 1] > 2 * err
            self.ties += int((~decided).sum())
            got, want = got[decided], want[decided]
        self.same(got, want, what)

    def done(self):
        never = [n for n, c in self.launched.items() if c <= 0]
        if self.bf16 and never:
            raise AssertionError(f"{self.label}: {never} never launched")
        tol = f"{BF16_MODEL_TOL} x max(1, |plain|)" if self.bf16 \
            else f"{MODEL_TOL}"
        side = "card, plain attention" if self.bf16 else "cpu"
        log(f"[model] {self.label} {str(self.dtype)[6:]}: card (kernels "
            f"{self.launched}) vs {side}: worst err/tol {self.worst:.3f} "
            f"(tol {tol}); next tokens equal at {self.compared} rows"
            + (f", {self.ties} near ties not compared" if self.bf16 else ""))
        if not self.n_layers:
            return
        if not self.bf16:
            log(f"[model] {self.label} f32: routes and capacity slots equal "
                f"at {self.pairs} (token, layer) pairs")
            return
        how = ("the kernel side pinned to the plain side's routes; its "
               "own top-k" if self.pin else
               "both sides free-running, counted, not compared")
        log(f"[model] {self.label} bf16 routes ({how}): {self.pairs_flipped}"
            f" of {self.pairs} (token, layer) pairs chose other experts; "
            f"{self.flipped} of {self.tokens} real tokens in some layer")


def gather_chunks(vocab, scratch, Np, page, rng):
    """The chunk sequence of tests/test_paged_runner.py's
    ``test_lm_prefill_paged_bitwise_matches_gather``: three full chunks of
    sequence A, a sequence B sharing A's first two pages, a sequence C
    whose final chunk is ragged (16 real lanes of 32, the rest parked on
    the scratch page). Tokens are drawn from ``rng`` in [1, vocab). Yields
    (n_real, toks, pos, table, wp, wo, kv_len) as numpy; the CPU tests
    use it too."""
    lane = 32
    table_a, table_b = [0, 1, 2, scratch], [0, 1, 4, scratch]
    table_c = [5, 6, scratch, scratch]
    i = np.arange(lane)
    for start, n_real, table in ((0, 32, table_a), (32, 32, table_a),
                                 (64, 32, table_a), (64, 32, table_b),
                                 (0, 32, table_c), (32, 16, table_c)):
        toks = np.zeros(lane, np.int32)
        toks[:n_real] = rng.integers(1, vocab, n_real)
        pos = np.arange(start, start + lane, dtype=np.int32)
        pos[n_real:] = Np * page - 1
        table = np.asarray(table, np.int32)
        wp = np.where(i < n_real, table[np.minimum((start + i) // page,
                                                   Np - 1)],
                      scratch).astype(np.int32)
        wo = np.where(i < n_real, (start + i) % page,
                      i % page).astype(np.int32)
        yield (n_real, toks[None], pos[None], table, wp, wo,
               np.int32(start + n_real))


def _prefill_gather_check(cfg, dtype) -> None:
    """``lm_prefill_paged_gather`` (the dense view through ``lm_step``:
    the flash_attention kernel) against ``lm_prefill_paged`` (the
    paged_flash_attention kernel) on the card, same weights and pool,
    over ``gather_chunks``. Both kernels share the ``attn_mma.cuh`` core,
    so each side is also held against a third run of the paged prefill
    under ``_plain_attention`` (no kernel launched). Real-row logits and
    non-scratch pages within MODEL_TOL in f32, BF16_MODEL_TOL times the
    largest magnitude in bf16. Both kernels must launch."""
    bf16 = dtype == torch.bfloat16
    params = tf.init_lm(cfg, torch.Generator(device=DEV).manual_seed(0),
                        dtype, DEV)
    page, P, Np = 32, 8, 4
    scratch = P - 1
    rng = np.random.default_rng(17)
    shp = (cfg.n_layers, P, page, cfg.n_kv_heads, cfg.head_dim_)
    k0 = torch.from_numpy(rng.standard_normal(shp, np.float32) * 0.5)
    v0 = torch.from_numpy(rng.standard_normal(shp, np.float32) * 0.5)
    gather = tf.PagedKVCache(k0.to(DEV, dtype), v0.to(DEV, dtype))
    paged = tf.PagedKVCache(k0.to(DEV, dtype), v0.to(DEV, dtype))
    plain = tf.PagedKVCache(k0.to(DEV, dtype), v0.to(DEV, dtype))
    live = [p for p in range(P) if p != scratch]
    worst = {"logits": 0.0, "pages": 0.0, "plain logits": 0.0,
             "plain pages": 0.0}
    share = {}                  # the largest err / tol of each comparison

    def agree(got, want, what):
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_MODEL_TOL * max(1.0, want.float().abs().max().item()) \
            if bf16 else MODEL_TOL
        worst[what] = max(worst[what], err)
        share[what] = max(share.get(what, 0.0), err / tol)
        if not err <= tol:
            raise AssertionError(f"prefill gather {cfg.name} {dtype} {what}: "
                                 f"max abs err {err} > {tol}")

    _zero_launches()
    for n, *arrays, kv in gather_chunks(cfg.vocab_size, scratch, Np, page,
                                        rng):
        args = [torch.from_numpy(a).to(DEV) for a in arrays]
        lg, gather = tf.lm_prefill_paged_gather(cfg, params, gather, *args)
        kv = torch.tensor(kv, device=DEV)
        ln, paged = tf.lm_prefill_paged(cfg, params, paged, *args, kv)
        before = _launch_counts()
        with _plain_attention():
            lp, plain = tf.lm_prefill_paged(cfg, params, plain, *args, kv)
        if _launch_counts() != before:
            raise AssertionError("prefill gather check: the plain side "
                                 "launched a kernel")
        agree(ln[:, :n], lg[:, :n], "logits")
        agree(paged.k[:, live], gather.k[:, live], "pages")
        agree(paged.v[:, live], gather.v[:, live], "pages")
        for got, pool in ((lg, gather), (ln, paged)):
            agree(got[:, :n], lp[:, :n], "plain logits")
            agree(pool.k[:, live], plain.k[:, live], "plain pages")
            agree(pool.v[:, live], plain.v[:, live], "plain pages")
    torch.cuda.synchronize()
    launches = {name: _launches(name) for name in
                ("flash_attention", "paged_flash_attention")}
    log(f"[model] prefill gather vs paged, {cfg.name} {dtype}: logits "
        f"{worst['logits']:.3e}, pages {worst['pages']:.3e}; either vs "
        f"plain attention: logits {worst['plain logits']:.3e}, pages "
        f"{worst['plain pages']:.3e}; largest share of the tolerance "
        f"{ {k: round(v, 4) for k, v in share.items()} }; launches "
        f"{launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"prefill gather check: {name} never "
                                 f"launched")


def phase_model(dtype=torch.float32, cfg=None) -> None:
    """llama3.2-1b .reduced() on the paged pool (see _ModelParity); in
    bf16 at the serving instances' head dim and group (D 64, G 4). With
    ``cfg`` (a reduced MoE config, f32) the same calls on that model, its
    routes and capacity slots held equal. On llama, then the gather
    baseline against the paged prefill (_prefill_gather_check): the
    reduced config in f32, the full width in bf16."""
    llama = cfg is None
    if cfg is None:
        over = dict(head_dim=64, n_heads=8) if dtype == torch.bfloat16 \
            else {}
        cfg = get_config("llama3.2-1b").reduced(**over)
        label = f"llama3.2-1b reduced {over}"
    else:
        label = cfg.name
    mp = _ModelParity(label, dtype,
                      ("paged_flash_attention", "paged_attention_fused"),
                      n_layers=cfg.n_layers if cfg.family == "moe" else 0)
    rparams, dparams = mp.params(
        tf.init_lm(cfg, torch.Generator().manual_seed(0), torch.float32))
    page, P, Np = 32, 12, 4
    scratch = P - 1
    rng = np.random.default_rng(3)
    shp = (cfg.n_layers, P, page, cfg.n_kv_heads, cfg.head_dim_)
    k0 = torch.from_numpy(rng.standard_normal(shp, np.float32) * 0.5)
    v0 = torch.from_numpy(rng.standard_normal(shp, np.float32) * 0.5)
    rcache, dcache = mp.cache(tf.PagedKVCache, k0, v0)

    def pools(what):
        live = [p for p in range(P) if p != scratch]
        mp.agree(dcache.k[:, live], rcache.k[:, live], what + " k pages")
        mp.agree(dcache.v[:, live], rcache.v[:, live], what + " v pages")

    def both(fn, *args, real=None):
        return mp.run(
            fn, (cfg, rparams, rcache,
                 *(torch.as_tensor(x).to(mp.ref_dev) for x in args)),
            (cfg, dparams, dcache, *(torch.as_tensor(x).to(DEV)
                                     for x in args)), real)

    # chunked prefill: two chunks, the second ragged (20 real of 32)
    table = np.array([0, 1, scratch, scratch], np.int32)
    for start, n in ((0, 32), (32, 20)):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :n] = rng.integers(2, cfg.vocab_size, n)
        pos = np.full((1, 32), Np * page - 1, np.int32)
        pos[0, :n] = np.arange(start, start + n)
        wp = np.full((32,), scratch, np.int32)
        wp[:n] = table[(start + np.arange(n)) // page]
        wo = np.arange(32, dtype=np.int32) % page
        wo[:n] = (start + np.arange(n)) % page
        (lc, _), (lg, _) = both(tf.lm_prefill_paged, toks, pos, table, wp, wo,
                                np.int32(start + n), real=[n])
        mp.agree(lg[:, :n], lc[:, :n], f"prefill logits @{start}")
        mp.same_next(lg[0, n - 1], lc[0, n - 1], f"prefill @{start}")
        pools(f"prefill @{start}")
    # decode: lanes at 53 (continuing), 70 and 5 (pool garbage as context)
    tables = np.array([[0, 1, scratch], [2, 3, 4], [5, scratch, scratch],
                       [scratch] * 3], np.int32)
    lens = np.array([53, 70, 5, 1], np.int32)
    wp = np.array([1, 4, 5, scratch], np.int32)
    wo = np.array([52 % page, 69 % page, 4, 0], np.int32)
    toks = np.array([7, 9, 11, 0], np.int32)
    (lc, _), (lg, _) = both(tf.lm_decode_paged, toks, lens - 1, tables, lens,
                            wp, wo, real=[3])
    mp.agree(lg[:3], lc[:3], "decode logits")
    mp.same_next(lg[:3], lc[:3], "decode")
    pools("decode")
    # one mixed iteration: a pack into pages 6/7 plus the decode lanes
    C = 32
    p_toks = np.zeros((1, 1, C), np.int32)
    p_toks[0, 0, :24] = rng.integers(2, cfg.vocab_size, 24)
    p_pos = np.full((1, 1, C), Np * page - 1, np.int32)
    p_pos[0, 0, :24] = np.arange(24)
    p_tab = np.array([[6, 7, scratch, scratch]], np.int32)
    p_wp = np.full((1, C), scratch, np.int32)
    p_wp[0, :24] = 6
    p_wo = np.arange(C, dtype=np.int32)[None] % page
    lens2 = np.array([54, 71, 6, 1], np.int32)          # lane 3 stays idle
    wo2 = np.array([53 % page, 70 % page, 5, 0], np.int32)
    (pc, dc, _), (pg, dg, _) = both(
        tf.lm_mixed_paged, p_toks, p_pos, p_tab, p_wp, p_wo,
        np.array([24], np.int32), np.array([23], np.int32), toks, lens2 - 1,
        tables, lens2, wp, wo2, real=[24, 3])
    if mp.bf16:     # tokens without logits cannot tell a near tie: the
        # pools below carry the bf16 check of this call
        log(f"[model] bf16 mixed next tokens: kernels {pg.tolist()}/"
            f"{dg[:3].tolist()}, plain {pc.tolist()}/{dc[:3].tolist()}")
    else:
        mp.same(pg, pc, "mixed prefill")
        mp.same(dg[:3], dc[:3], "mixed decode")
    pools("mixed")
    mp.done()
    if llama:
        _prefill_gather_check(
            get_config("llama3.2-1b") if mp.bf16 else cfg, dtype)


def phase_model_dense(dtype=torch.float32, cfg=None) -> None:
    """gemma2-27b .reduced() (window 64, softcaps, post norms, tied
    embeddings) on the dense cache (see _ModelParity); in bf16 at the
    serving instance's head dim (D 128). With ``cfg`` (a reduced MoE
    config, f32) the same calls on that model, routes held equal."""
    if cfg is None:
        over = dict(head_dim=128) if dtype == torch.bfloat16 else {}
        cfg = get_config("gemma2-27b").reduced(**over)
        label = f"gemma2-27b reduced {over} (dense cache)"
    else:
        label = f"{cfg.name} (dense cache)"
    mp = _ModelParity(label, dtype, ("flash_attention",),
                      n_layers=cfg.n_layers if cfg.family == "moe" else 0)
    rparams, dparams = mp.params(
        tf.init_lm(cfg, torch.Generator().manual_seed(0), torch.float32))
    rng = np.random.default_rng(4)

    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 90))
                            .astype(np.int32))
    lc, lg = mp.run(tf.lm_forward, (cfg, rparams, toks.to(mp.ref_dev)),
                    (cfg, dparams, toks.to(DEV)))
    mp.agree(lg, lc, "lm_forward logits")
    mp.same_next(lg[:, -1], lc[:, -1], "lm_forward")
    Smax, slot = 160, 1
    shp = (cfg.n_layers, 3, Smax, cfg.n_kv_heads, cfg.head_dim_)
    k0 = torch.from_numpy(rng.standard_normal(shp, np.float32) * 0.5)
    v0 = torch.from_numpy(rng.standard_normal(shp, np.float32) * 0.5)
    rcache, dcache = mp.cache(tf.KVCache, k0, v0)

    def caches(what):
        mp.agree(dcache.k[:, :, :Smax - 1], rcache.k[:, :, :Smax - 1],
                 what + " k")
        mp.agree(dcache.v[:, :, :Smax - 1], rcache.v[:, :, :Smax - 1],
                 what + " v")

    def slot_of(c):
        return tf.KVCache(c.k[:, slot:slot + 1], c.v[:, slot:slot + 1])

    # two chunks into one slot; the second is ragged (20 real of 32, the
    # padded lanes parked at Smax - 1) and past the 64-token window
    nxt = 0
    for start, n, lane in ((0, 64, 64), (64, 20, 32)):
        t = np.zeros((1, lane), np.int32)
        t[0, :n] = rng.integers(2, cfg.vocab_size, n)
        t = torch.from_numpy(t)
        kw = dict(q_offset=start, n_real=n)
        (lc, _), (lg, _) = mp.run(
            lambda *a: tf.lm_step(*a, **kw),
            (cfg, rparams, slot_of(rcache), t.to(mp.ref_dev)),
            (cfg, dparams, slot_of(dcache), t.to(DEV)), real=[n])
        mp.agree(lg[:, :n], lc[:, :n], f"lm_step logits @{start}")
        mp.same_next(lg[0, n - 1], lc[0, n - 1], f"lm_step @{start}")
        if not torch.isfinite(lg).all():
            raise AssertionError("dense model: padded lanes not finite")
        caches(f"lm_step @{start}")
        nxt = int(torch.argmax(lc[0, n - 1]))
    # decode: slot 0 at 100 (random cache as context), slot 1 continuing
    # its prefill at 84, slot 2 idle at the scratch position
    t = torch.tensor([7, nxt, 0], dtype=torch.int32)
    pos = torch.tensor([100, 84, Smax - 1], dtype=torch.int32)
    (lc, _), (lg, _) = mp.run(
        tf.lm_decode, (cfg, rparams, rcache, t.to(mp.ref_dev),
                       pos.to(mp.ref_dev)),
        (cfg, dparams, dcache, t.to(DEV), pos.to(DEV)), real=[2])
    mp.agree(lg[:2], lc[:2], "lm_decode logits")
    mp.same_next(lg[:2], lc[:2], "lm_decode")
    caches("lm_decode")
    mp.done()


def phase_model_rwkv() -> None:
    """rwkv6-1.6b .reduced() (H 4, K 32): card (wkv6 kernel) vs CPU (plain
    recurrence), f32, same weights: forward, prefill, three decode steps
    and a forward resumed from the carried state. Errors are taken
    relative to the tensor's largest magnitude (at least 1): the wkv state
    reaches tens and the per-head group norm amplifies f32 rounding where
    a head's output has little variance, as in tests/test_torch_rwkv.py."""
    cfg = get_config("rwkv6-1.6b").reduced()
    params = model_zoo.init(cfg, 0, torch.float32, device="cpu")
    dparams = _to_device(params)
    rng = np.random.default_rng(5)
    worst = 0.0

    def agree(a, b, what):
        nonlocal worst
        scale = max(1.0, b.float().abs().max().item())
        err = (a.float().cpu() - b.float()).abs().max().item() / scale
        worst = max(worst, err)
        if not err <= MODEL_TOL:
            raise AssertionError(f"rwkv model {what}: max abs err {err} "
                                 f"of the magnitude {scale}")

    def states(g, c, what):
        for f in ("att_shift", "ffn_shift", "wkv"):
            agree(getattr(g, f), getattr(c, f), f"{what} {f}")

    def same_next(c, g, what):
        if torch.argmax(c, -1).tolist() != torch.argmax(g, -1).cpu().tolist():
            raise AssertionError(f"rwkv model {what}: next tokens differ")

    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                            .astype(np.int32))
    lc = rwkv6.rwkv_forward(cfg, params, toks)
    lg = rwkv6.rwkv_forward(cfg, dparams, toks.to(DEV))
    agree(lg, lc, "rwkv_forward logits")
    lc, sc = rwkv6.rwkv_prefill(cfg, params, toks)
    lg, sg = rwkv6.rwkv_prefill(cfg, dparams, toks.to(DEV))
    agree(lg, lc, "rwkv_prefill logits")
    states(sg, sc, "rwkv_prefill")
    same_next(lc, lg, "rwkv_prefill")
    for step in range(3):
        nxt = torch.argmax(lc, -1).to(torch.int32)
        lc, sc = rwkv6.rwkv_decode(cfg, params, sc, nxt)
        lg, sg = rwkv6.rwkv_decode(cfg, dparams, sg, nxt.to(DEV))
        agree(lg, lc, f"rwkv_decode {step} logits")
        states(sg, sc, f"rwkv_decode {step}")
        same_next(lc, lg, f"rwkv_decode {step}")
    more = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                            .astype(np.int32))
    lc, sc = rwkv6.rwkv_forward(cfg, params, more, state=sc,
                                return_state=True)
    lg, sg = rwkv6.rwkv_forward(cfg, dparams, more.to(DEV), state=sg,
                                return_state=True)
    agree(lg, lc, "resumed rwkv_forward logits")
    states(sg, sc, "resumed rwkv_forward")
    same_next(lc[:, -1], lg[:, -1], "resumed rwkv_forward")
    log(f"[model] rwkv6-1.6b reduced f32: card vs cpu max abs err "
        f"{worst:.3e} of the largest magnitude (tol {MODEL_TOL}); next "
        f"tokens equal")


def _moe_ffn_full_width() -> None:
    """One full-width Qwen3-Coder ``moe_ffn`` (E 128, K 8, D 2048, F 768)
    over 256 tokens in f32, card against CPU on the same weights (drawn
    with JAX's init_moe scales): routes and capacity slots equal (the
    capacity, 20 an expert, drops entries by design), outputs within
    MOE_FFN_REL_TOL of the largest output."""
    from repro_torch.models import layers
    cfg, T = QWEN3, 256
    m, D = cfg.moe, cfg.d_model
    E, Fe = m.num_experts, m.d_ff_expert
    gen = torch.Generator(device=DEV).manual_seed(3)
    p = {"router": torch.randn((D, E), generator=gen, device=DEV) * D ** -0.5,
         "w_gate": torch.randn((E, D, Fe), generator=gen, device=DEV)
         * D ** -0.5,
         "w_up": torch.randn((E, D, Fe), generator=gen, device=DEV)
         * D ** -0.5,
         "w_down": torch.randn((E, Fe, D), generator=gen, device=DEV)
         * Fe ** -0.5}
    x = torch.randn((1, T, D), generator=gen, device=DEV)
    with _routes() as got_r:
        got = layers.moe_ffn(cfg, p, x)
    torch.cuda.synchronize()
    with _routes() as want_r:
        want = layers.moe_ffn(cfg, {k: v.cpu() for k, v in p.items()},
                              x.cpu())
    g, w = got_r[0], want_r[0]
    if not (torch.equal(g["idx"], w["idx"])
            and torch.equal(g["pos"], w["pos"])):
        raise AssertionError("moe_ffn full width: routes or capacity slots "
                             "differ between card and CPU")
    scale = want.abs().max().item()
    err = (got.cpu() - want).abs().max().item()
    if not err <= MOE_FFN_REL_TOL * scale:
        raise AssertionError(f"moe_ffn full width: max abs err {err} > "
                             f"{MOE_FFN_REL_TOL} x {scale}")
    cap = max(8, int(T * m.top_k / E * m.capacity_factor))
    log(f"[model] moe_ffn full width f32 (E {E}, K {m.top_k}, D {D}, F "
        f"{Fe}, {T} tokens, capacity {cap} an expert): routes "
        f"and slots equal, {int((~w['keep']).sum())} of "
        f"{w['keep'].numel()} entries "
        f"dropped; card vs cpu max abs err {err:.3e} of {scale:.3e} (tol "
        f"{MOE_FFN_REL_TOL} x)")


MOE_BF16 = dict(layers=4, page=32, P=420, Np=48, C=256,
                lanes=(457, 1090, 1131, 1160, 1188, 1216, 1270, 1310))


def _moe_bf16_pass(cfg, params, k0, v0, pin: bool) -> None:
    """One pass of phase_model_moe_bf16's calls with a fresh pair of
    pools from k0/v0 (f32, on the card). ``pin``: the kernel side routes
    as the plain side did, and logits, next tokens and the pool slots each
    real token wrote are compared on every token; otherwise both sides
    route freely and the re-routed tokens are only counted."""
    bf16, S = torch.bfloat16, MOE_BF16
    page, P, Np, C = S["page"], S["P"], S["Np"], S["C"]
    V, scratch = cfg.vocab_size, S["P"] - 1
    mp = _ModelParity(f"qwen3-coder-30b-a3b full width, {cfg.n_layers} "
                      "layers", bf16, ("paged_flash_attention",
                                       "paged_attention_fused"),
                      n_layers=cfg.n_layers, pin=pin)
    rcache, dcache = mp.cache(tf.PagedKVCache, k0, v0)
    rng = np.random.default_rng(8)
    perm = rng.permutation(scratch)
    i32 = (lambda a: torch.as_tensor(np.asarray(a, np.int32), device=DEV))

    def table(pages):
        t = np.full((Np,), scratch, np.int32)
        t[:len(pages)] = pages
        return t

    def chunk(tab, start, n):
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = rng.integers(2, V, n)
        pos = np.full((1, C), Np * page - 1, np.int32)
        pos[0, :n] = np.arange(start, start + n)
        wp = np.full((C,), scratch, np.int32)
        wp[:n] = tab[(start + np.arange(n)) // page]
        wo = np.arange(C, dtype=np.int32) % page
        wo[:n] = (start + np.arange(n)) % page
        return toks, pos, wp, wo

    def slots(wp, wo, n, what):
        """The pool slots the first ``n`` (real) tokens wrote, every
        layer."""
        if not pin:
            return
        wp, wo = (torch.as_tensor(a)[:n].long().to(DEV) for a in (wp, wo))
        for name in ("k", "v"):
            mp.agree(getattr(dcache, name)[:, wp, wo],
                     getattr(rcache, name)[:, wp, wo], f"{what} {name} slots")

    def logits(got, want, what):
        if pin:
            mp.agree(got, want, what + " logits")
            mp.same_next(got, want, what)

    def both(fn, *args, real):
        return mp.run(fn, (cfg, params, rcache, *map(i32, args)),
                      (cfg, params, dcache, *map(i32, args)), real)

    tab_a = table(perm[:16])
    nxt = 0
    for start, n in ((0, C), (C, 200)):
        toks, pos, wp, wo = chunk(tab_a, start, n)
        (lc, _), (lg, _) = both(tf.lm_prefill_paged, toks, pos, tab_a, wp,
                                wo, start + n, real=[n])
        logits(lg[0, :n], lc[0, :n], f"prefill @{start}")
        slots(wp, wo, n, f"prefill @{start}")
        nxt = int(torch.argmax(lc[0, n - 1]))
    # decode: lane 0 continues the prefill, lanes 1-7 read pool context
    lens = np.array(S["lanes"], np.int32)
    tabs, first = [tab_a], 16
    for n in lens[1:]:
        need = -(-(int(n) + 1) // page)
        tabs.append(table(perm[first:first + need]))
        first += need
    tabs = np.stack(tabs)
    B = len(lens)
    d_toks = np.concatenate([[nxt], rng.integers(2, V, B - 1)])

    def lanes(lens):
        wp = tabs[np.arange(B), (lens - 1) // page]
        return lens - 1, tabs, lens, wp, (lens - 1) % page

    (lc, _), (lg, _) = both(tf.lm_decode_paged, d_toks, *lanes(lens),
                            real=[B])
    logits(lg, lc, "decode")
    slots(*lanes(lens)[3:], B, "decode")
    # one mixed iteration: a 230-token pack of a new sequence + the lanes
    tab_b = table(perm[first:first + C // page])
    toks, pos, wp, wo = chunk(tab_b, 0, 230)
    d_toks = torch.argmax(lc, -1).cpu().numpy()
    (pc, dc, _), (pg, dg, _) = both(
        tf.lm_mixed_paged, toks[None], pos[None], tab_b[None], wp[None],
        wo[None], [230], [229], d_toks, *lanes(lens + 1), real=[230, B])
    slots(wp, wo, 230, "mixed pack")
    slots(*lanes(lens + 1)[3:], B, "mixed decode")
    if pin:
        log(f"[model] bf16 full-width mixed next tokens: kernels "
            f"{pg.tolist()}/{dg.tolist()}, plain {pc.tolist()}/"
            f"{dc.tolist()}")
    mp.done()


def phase_model_moe_bf16() -> None:
    """qwen3-coder-30b-a3b at full width with 4 layers, bf16, on the paged
    pool: the kernels against the plain attention on the card (see
    _ModelParity): two prefill chunks of C 256 (the second ragged, 200
    real), a decode step over 8 lanes (one continuing the prefill, seven
    over 1.1k-1.3k tokens of pool context), then one mixed iteration (a
    pack of 230 real tokens of a new sequence plus the 8 lanes). Twice:
    both sides routing freely, the re-routed tokens counted; then the
    kernel side pinned to the plain side's routes, logits, next tokens and
    the pool slots every real token wrote compared."""
    cfg = dataclasses.replace(QWEN3, n_layers=MOE_BF16["layers"])
    S = MOE_BF16
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = tf.init_lm(cfg, gen, torch.bfloat16, DEV)
    shp = (cfg.n_layers, S["P"], S["page"], cfg.n_kv_heads, cfg.head_dim_)
    k0 = torch.randn(shp, generator=gen, device=DEV) * 0.5
    v0 = torch.randn(shp, generator=gen, device=DEV) * 0.5
    for pin in (False, True):
        _moe_bf16_pass(cfg, params, k0, v0, pin)


def phase_model_moe() -> None:
    """The MoE family: granite-moe-3b-a800m and qwen3-coder-30b-a3b
    .reduced() through the paged calls of phase_model and the dense-cache
    calls of phase_model_dense, f32, card against CPU, routes and capacity
    slots equal; one full-width moe_ffn in f32; then qwen3-coder-30b-a3b
    at full width with 4 layers in bf16."""
    for cfg in (get_config("granite-moe-3b-a800m").reduced(),
                QWEN3.reduced()):
        phase_model(torch.float32, cfg)
        phase_model_dense(torch.float32, cfg)
    _moe_ffn_full_width()
    phase_model_moe_bf16()
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 5. serve at full width
# ---------------------------------------------------------------------------

SERVE = dict(n_sessions=8, shared_tokens=1024, tail_chunks=(2, 3, 4, 2),
             decode=16, total_pages=2048)


def _sessions(run: int):
    rng = np.random.default_rng(run)
    out = []
    for i in range(SERVE["n_sessions"]):
        fam = i % 2
        tail = SERVE["tail_chunks"][i % 4]
        # the private tail ends in a partial 16-token chunk: indexed by the
        # radix, so the first decode into it takes a copy-on-write
        first = SERVE["shared_tokens"] + 32 * tail + 16
        tools = rng.uniform(0.2, 0.5, 2)
        rounds = [Round(first, SERVE["decode"], "sleep", float(tools[0])),
                  Round(48, SERVE["decode"], "sleep", float(tools[1])),
                  Round(32, SERVE["decode"], None, 0.0)]
        s = make_session(0.1 * i, rounds, ideal_time=2.0)
        s.meta["prefix_hashes"] = \
            [(("smoke-fam", run, fam, c), 32)
             for c in range(SERVE["shared_tokens"] // 32)] + \
            [(("smoke-u", s.sid, c), 32) for c in range(tail)] + \
            [(("smoke-u", s.sid, "part"), 16)]
        out.append(s)
    return out


def _serve(backend, sessions, ecfg, *, force_offload: bool, install=None,
           label=None):
    """One Engine run over ``sessions`` under MARS with real tools; checks
    that every session finished with the right number of in-vocabulary
    tokens and, under forced offload, that a host swap-out happened.
    ``install(eng)`` runs before the first tick (the obs and fault
    phases' hooks). Returns (engine, wall seconds)."""
    bus = EventBus()
    tools = RealToolExecutor(cpu_slots=4, bus=bus)
    eng = Engine(EngineConfig(**ecfg), "mars", backend, bus=bus,
                 tool_exec=tools)
    if force_offload:
        eng.policy.on_tool_yield = lambda s, now: (KVAction.OFFLOAD, 0.0)
    if install is not None:
        install(eng)
    try:
        t0 = time.monotonic()
        finished, horizon = run_live(eng, sessions, timeout=300)
        wall = time.monotonic() - t0
    finally:
        tools.shutdown()
    eng.check_invariants()
    label = label or ("offload" if force_offload else "mars")
    if len(finished) != len(sessions):
        raise AssertionError(f"serve[{label}]: {len(finished)} of "
                             f"{len(sessions)} sessions finished")
    V = backend.cfg.vocab_size
    for s in finished:
        gen = s.meta.get("generated", [])
        if len(gen) != sum(r.decode_tokens for r in s.rounds) or \
                not all(0 <= t < V for t in gen):
            raise AssertionError(f"serve[{label}] sid={s.sid}: bad tokens")
        log(f"[serve:{label}] sid={s.sid} e2e={s.e2e_latency:.3f}s "
            f"tokens={len(gen)} ttfts={[round(t, 4) for t in s.ttfts]}")
    outs = [e for e in bus.log if e.kind == ev.SWAP_OUT
            and e.data.get("tier") == "host"]
    log(f"[serve:{label}] finished {len(finished)}/{len(sessions)} in "
        f"{wall:.2f}s wall, prefix_hit_tokens={eng.prefix_hit_tokens}, "
        f"host swap-outs={len(outs)}, cow={eng.blocks.cow_count}")
    if force_offload and not outs:
        raise AssertionError("serve[offload]: no host SWAP_OUT")
    return eng, wall


def _serve_paged(backend, run: int, *, force_offload: bool, install=None,
                 label=None):
    label = label or ("offload" if force_offload else "mars")
    eng, wall = _serve(backend, _sessions(run),
                       dict(total_kv_blocks=SERVE["total_pages"],
                            block_size=32, token_budget=512,
                            max_decode_batch=8, cpu_slots=4,
                            scheduler="mixed"),
                       force_offload=force_offload, install=install,
                       label=label)
    if eng.prefix_hit_tokens <= 0:
        raise AssertionError(f"serve[{label}]: no prefix hits")
    if eng.blocks.cow_count <= 0:
        raise AssertionError(f"serve[{label}]: no copy-on-write ran")
    return eng, wall


def phase_serve():
    cfg = get_config("llama3.2-1b")
    t0 = time.monotonic()
    backend = TorchBackend(cfg, device="cuda", dtype=torch.bfloat16, seed=0,
                           total_pages=SERVE["total_pages"], page_size=32,
                           max_slots=8)
    torch.cuda.synchronize()
    log(f"[serve] llama3.2-1b full width (L={cfg.n_layers} d={cfg.d_model} "
        f"Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} V={cfg.vocab_size}) bf16, "
        f"{SERVE['total_pages']} pages: set-up {time.monotonic() - t0:.2f}s, "
        f"prefill {1.0 / backend.prefill_rate() * 1e6:.1f} us/token "
        f"(calibrated)")
    _zero_launches()
    try:
        _, mars_wall = _serve_paged(backend, 0, force_offload=False)
        eng, _ = _serve_paged(backend, 1, force_offload=True)
    finally:
        backend.close()
    launches = _launch_counts()
    st = backend.dispatch_stats
    if st["mixed_calls"] <= 0:
        raise AssertionError("serve: no mixed iteration ran")
    log(f"[serve] on {torch.cuda.get_device_name(0)}: dispatch_stats " +
        json.dumps(
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in st.items()}))
    log(f"[serve] swap_stream {json.dumps(backend.swap_stream_stats())}")
    log(f"[serve] kernel launches on the main path: {launches}")
    for name in MAIN_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"serve: {name} never launched")
    del eng
    return launches, backend.params, mars_wall


# ---------------------------------------------------------------------------
# 5b. the observability plane, fault injection and the cluster router on
#     the live serve (full-width llama3.2-1b, bf16, paged)
# ---------------------------------------------------------------------------

BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
PARTITION_REL = 0.01     # tests/test_obs.py's bar for a sim run's buckets
# tick thresholds a fault window can pass on the live clock (run_live
# idles 5 ms a tick; a full-width mixed tick takes ~70 ms), multiples of
# the detectors' scan stride of 8
FAULT_DETECT = dict(livelock_ticks=64, admission_stall_ticks=64)
FAULT_CAP_S = 20.0       # a fault window ends at its incident, or here
ROUTER_SERVE = dict(pages=1024)
# the router's straggler penalty, (tick-seconds EMA / median - 1) capped:
# at the default cap of 2.0 a replica in a long prefill tick scores up to
# 1.0 worse than an idle one and the family bonus (0.5 x the digest
# match) loses: a sibling can go to the replica without its family.
# RouterConfig says the penalty should break ties, not drown affinity;
# 0.25 keeps it under both affinity bonuses (0.35, 0.5 x >= 0.86)
ROUTER_CONFIG = dict(heartbeat_timeout=1.0, straggler_penalty_cap=0.25)


def _require_paged(label: str, launches: dict) -> None:
    log(f"[{label}] kernel launches: {launches}")
    for name in MAIN_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} never launched")


def _llama_backend(params, pages: int = SERVE["total_pages"]):
    return TorchBackend(get_config("llama3.2-1b"), params=params,
                        device="cuda", dtype=torch.bfloat16,
                        total_pages=pages, page_size=32, max_slots=8)


def phase_serve_obs(params, mars_wall: float) -> dict:
    """phase_serve's MARS run (seed 0) with the whole obs stack on the
    engine's bus: critical-path tracer with a metrics registry and the
    engine probes, detectors, SLO tracker and flight recorder."""
    backend = _llama_backend(params)
    reg = MetricsRegistry()
    out = os.path.join(BUILD, "flight", "obs")
    shutil.rmtree(out, ignore_errors=True)
    stack = {}

    def install(eng):
        stack["tracer"] = Tracer.install(eng, metrics=reg)
        bind_engine_probes(reg, eng)
        stack["detect"] = DetectorSuite.install(eng, metrics=reg)
        stack["slo"] = SloTracker.install(eng, metrics=reg)
        stack["rec"] = FlightRecorder.install(eng, out)

    _zero_launches()
    try:
        eng, wall = _serve_paged(backend, 0, force_offload=False,
                                 install=install, label="obs")
    finally:
        backend.close()
    launches = _launch_counts()
    tr, detect, slo = stack["tracer"], stack["detect"], stack["slo"]
    sids = tr.finished_sids()
    if sorted(sids) != sorted(s.sid for s in eng.finished):
        raise AssertionError(f"serve-obs: traced {sids}")
    worst = 0.0
    for sid in sids:
        cp = tr.critical_path(sid)
        rel = abs(sum(cp["buckets"].values()) - cp["e2e"]) / cp["e2e"]
        worst = max(worst, rel)
        if not rel <= PARTITION_REL or min(cp["buckets"].values()) < 0:
            raise AssertionError(f"serve-obs sid={sid}: buckets "
                                 f"{cp['buckets']} against e2e {cp['e2e']}")
    agg = tr.aggregate()
    log(f"[serve-obs] {len(sids)} sessions; buckets sum to e2e within "
        f"{worst:.3e} (limit {PARTITION_REL}); per plane (s) "
        f"{ {k: round(v, 4) for k, v in agg['buckets'].items()} }, "
        f"shares {json.dumps({k: round(v, 4) for k, v in agg['bucket_frac'].items()})}")
    rep = slo.report()
    scored = sum(c["sessions"] for c in rep["classes"].values())
    fin = sum(c["finished"] for c in rep["classes"].values())
    if scored != len(eng.finished) or fin != scored:
        raise AssertionError(f"serve-obs: SLO tracker scored {scored}, "
                             f"finished {fin}")
    log("[serve-obs] goodput " + json.dumps(
        {name: {k: c[k] for k in ("sessions", "good", "goodput_frac",
                                  "goodput_rps", "violations")}
         for name, c in rep["classes"].items()}))
    if detect.count():
        raise AssertionError(f"serve-obs: incidents on a clean run: "
                             f"{detect.incidents}")
    snap = reg.snapshot()
    if snap["dispatch"]["mixed_calls"] <= 0:
        raise AssertionError("serve-obs: no mixed call in the dispatch probe")
    log(f"[serve-obs] dispatch probe (host seconds) " + json.dumps(
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in snap["dispatch"].items()}))
    log(f"[serve-obs] swap_stream probe {json.dumps(snap['swap_stream'])}")
    path = os.path.join(BUILD, "serve_obs_perfetto.json")
    export_perfetto(tr, path)
    with open(path) as f:
        doc = json.load(f)
    slices = [e for e in doc["traceEvents"]
              if e.get("ph") == "X" and "sid" in e.get("args", {})]
    want = sum(len(tr.sessions[sid].segments) for sid in sids)
    bad = [e for e in slices if e["args"].get("plane") not in PLANES
           or not e["args"].get("kind")]
    if len(slices) != want or bad:
        raise AssertionError(f"serve-obs: Perfetto holds {len(slices)} "
                             f"session slices for {want} spans, {len(bad)} "
                             f"without plane or kind")
    log(f"[serve-obs] Perfetto trace {os.path.getsize(path)} bytes, "
        f"{len(doc['traceEvents'])} events, {len(slices)} session slices")
    log(f"[serve-obs] wall {wall:.3f}s with the obs stack against "
        f"{mars_wall:.3f}s for serve's MARS run of the same seed "
        f"({wall / mars_wall:.3f}x; logged, not gated)")
    _require_paged("serve-obs", launches)
    return launches


def phase_serve_faults(params) -> dict:
    """The same scenario (seed 2) under a FaultPlan: admission frozen from
    the start, then the first session to decode frozen; each window ends
    at its incident (or at FAULT_CAP_S). stuck_tool bites only in the
    simulated tool executor, as in the reference; its check is on the CPU
    (tests/test_torch_slo_incidents.py)."""
    backend = _llama_backend(params)
    out = os.path.join(BUILD, "flight", "faults")
    shutil.rmtree(out, ignore_errors=True)
    plan = FaultPlan([Fault(kind="freeze_decode", at_s=0.0,
                            until_s=FAULT_CAP_S),
                      Fault(kind="frozen_admission", at_s=0.0,
                            until_s=FAULT_CAP_S)])
    stack = {}

    def close_window(e):
        kind = {"decode_livelock": "freeze_decode",
                "admission_stall": "frozen_admission"}.get(e.data["kind"])
        for f in plan.faults:
            if f.kind == kind and f.until_s > e.t:
                f.until_s = e.t
                log(f"[serve-faults] {e.data['kind']} sid={e.sid} at "
                    f"{e.t:.3f}s: {f.kind} window closed "
                    f"{json.dumps(e.data['evidence'])}")

    def install(eng):
        stack["detect"] = DetectorSuite.install(
            eng, config=DetectorConfig(**FAULT_DETECT))
        stack["rec"] = FlightRecorder.install(eng, out)
        eng.bus.subscribe(ev.INCIDENT, close_window)
        plan.install(eng)

    log(f"[serve-faults] DetectorConfig {FAULT_DETECT}, windows capped at "
        f"{FAULT_CAP_S}s")
    _zero_launches()
    try:
        eng, wall = _serve_paged(backend, 2, force_offload=False,
                                 install=install, label="faults")
    finally:
        backend.close()
    launches = _launch_counts()
    detect, rec = stack["detect"], stack["rec"]
    log(f"[serve-faults] plan {json.dumps(plan.summary())}; incidents "
        f"{[(i['kind'], i['sid'], round(i['t'], 3)) for i in detect.incidents]}")
    # the frozen sid, from the incident: the plan freezes one session, so
    # one sid stalls, and it alone took no decode step between its last
    # one before the incident and the incident while others decoded
    livelocks = [i for i in detect.incidents
                 if i["kind"] == "decode_livelock"]
    if len({i["sid"] for i in livelocks}) != 1 or not next(
            f for f in plan.summary() if f["kind"] == "freeze_decode")["hits"]:
        raise AssertionError(f"serve-faults: decode_livelock incidents "
                             f"{livelocks} for one frozen session expected")
    frozen, t_inc = livelocks[0]["sid"], livelocks[0]["t"]
    steps = [(e.t, e.sid) for e in eng.bus.of_kind(ev.DECODE_STEP)
             if e.t <= t_inc]
    last = max((t for t, sid in steps if sid == frozen), default=None)
    others = sum(1 for t, sid in steps if sid != frozen and last is not None
                 and t > last)
    log(f"[serve-faults] frozen sid {frozen}: last decode step at {last}, "
        f"{others} decode steps of other sessions before its incident at "
        f"{t_inc:.3f}s")
    if last is None or not others:
        raise AssertionError(f"serve-faults: sid {frozen} was not stalled "
                             f"alone (last step {last}, others {others})")
    if not detect.count("admission_stall"):
        raise AssertionError("serve-faults: no admission_stall while "
                             "admission was frozen")
    bundle = next((b for b in rec.bundles
                   if b.endswith("decode_livelock")), None)
    if bundle is None:
        raise AssertionError(f"serve-faults: no decode_livelock bundle in "
                             f"{rec.bundles}")
    events = load_events_jsonl(os.path.join(bundle, "events.jsonl"))
    replay = Tracer.replay(events)
    if frozen not in replay.sessions or not any(
            e.kind == ev.INCIDENT for e in events):
        raise AssertionError(f"serve-faults: bundle {bundle} does not "
                             f"replay the frozen session")
    with open(os.path.join(bundle, "incident.json")) as f:
        inc = json.load(f)
    log(f"[serve-faults] bundle {os.path.basename(bundle)}: {len(events)} "
        f"events replayed, critical path of sid {frozen} "
        f"{json.dumps(inc['critical_path'] and inc['critical_path']['buckets'])}")
    log(f"[serve-faults] every session finished after the windows in "
        f"{wall:.3f}s wall")
    _require_paged("serve-faults", launches)
    return launches


def _count_launches(backend, into: dict):
    """Attribute the kernels' launches to ``backend``: its run_batch adds
    the counters' growth over each call to ``into``."""
    run = backend.run_batch

    def counted(work, now):
        before = _launch_counts()
        try:
            return run(work, now)
        finally:
            for name, n in _launch_counts().items():
                into[name] = into.get(name, 0) + n - before[name]
    backend.run_batch = counted


def phase_serve_router(params) -> dict:
    """Two TorchBackend replicas on the card (each with its own weights,
    ROUTER_SERVE's pages) behind ClusterRouter, heartbeats every round
    carrying KV utilisation and the radix digest; the two-family sessions
    of serve (seed 3). Replica b stops ticking and beating (a crash) once
    every session has been placed, every one that arrived when a digest
    covered its family's shared prefix has attached to the family's pages,
    and a session of b is in a tool; the router fails it after
    heartbeat_timeout and re-places its sessions on a, where they resume
    by prefix recompute."""
    router = ClusterRouter(RouterConfig(**ROUTER_CONFIG))
    log(f"[serve-router] RouterConfig {ROUTER_CONFIG}")
    weights = {"a": params, "b": _tree_map(lambda t: t.clone(), params)}
    backends, engines, tools, per_replica = {}, {}, [], {}
    state = {"crashed": None}
    sessions = _sessions(3)
    try:
        for rid in ("a", "b"):
            backends[rid] = _llama_backend(weights[rid],
                                           ROUTER_SERVE["pages"])
            per_replica[rid] = {}
            _count_launches(backends[rid], per_replica[rid])
            bus = EventBus()
            tools.append(RealToolExecutor(cpu_slots=4, bus=bus))
            engines[rid] = Engine(EngineConfig(
                total_kv_blocks=ROUTER_SERVE["pages"], block_size=32,
                token_budget=512, max_decode_batch=8, cpu_slots=4,
                scheduler="mixed"), "mars", backends[rid], bus=bus,
                tool_exec=tools[-1])
            router.register(rid, engines[rid], now=0.0)
        both = dict(engines)
        detectors = {rid: DetectorSuite.install(e)
                     for rid, e in both.items()}
        # each session's first home, each replica's digest match (blocks)
        # when it arrived, and its first radix hit; a replica whose digest
        # covers the whole shared prefix has its family's builder indexed
        full = SERVE["shared_tokens"] // 32
        home, matches, loads, first_hit = {}, {}, {}, {}
        for rid, eng in both.items():
            eng.bus.subscribe(ev.SUBMIT, lambda x, rid=rid:
                              home.setdefault(x.sid, rid))
            eng.bus.subscribe(ev.PREFIX_HIT, lambda x, rid=rid:
                              first_hit.setdefault(x.sid, (rid, x.t)))

        def holders(sid):
            return sorted(rid for rid, m in matches[sid].items()
                          if m >= full)

        def on_round(now):
            # placement follows this call within the round, on the digests
            # of the last heartbeats: the ones read here
            for s in sessions:
                if s.sid not in matches and s.arrival_time <= now:
                    matches[s.sid] = {
                        rid: estimate_digest_match(r.radix_digest,
                                                   s.meta["prefix_hashes"])
                        for rid, r in router.replicas.items() if r.alive}
                    loads[s.sid] = {
                        rid: (round(r.kv_utilization, 4), r.tool_backlog,
                              r.active_sessions,
                              round(r.step_latency_ema, 4))
                        for rid, r in router.replicas.items() if r.alive}
            b = engines.get("b")
            if b is None or len(home) < len(sessions) or any(
                    holders(sid) and sid not in first_hit
                    for sid in matches) or not any(
                    s.phase == Phase.TOOL for s in b.active):
                return
            state["crashed"] = (now, {s.sid: (s.phase.value, s.decoded)
                                      for s in b.waiting + b.active})
            log(f"[serve-router] replica b crashes at {now:.3f}s holding "
                f"{state['crashed'][1]}")
            del engines["b"]

        _zero_launches()
        finished, wall = run_cluster_live(router, engines, sessions,
                                          timeout=300, on_round=on_round)
        launches = _launch_counts()
        for e in both.values():
            e.check_invariants()
    finally:
        for t in tools:
            t.shutdown()
        for b in backends.values():
            b.close()
    firsts = {sid: (home.get(sid), matches[sid], first_hit.get(sid))
              for sid in sorted(matches)}
    log(f"[serve-router] first placements (replica, digest match in blocks "
        f"by replica at arrival, first radix hit); the shared prefix is "
        f"{full} blocks: {firsts}")
    log(f"[serve-router] replica state at each arrival (kv utilisation, "
        f"tool backlog, active sessions, tick-seconds EMA): {loads}")
    # family co-location: every session that arrived after its family's
    # builder was indexed (a digest covering the shared prefix) went to a
    # replica holding it, and attached to the family's pages there before
    # the crash
    t_crash, held = state["crashed"] or (float("inf"), {})
    pulled = [sid for sid in matches if holders(sid)]
    if not pulled:
        raise AssertionError("serve-router: no family indexed in a digest")
    for sid in pulled:
        hit = first_hit.get(sid)
        if home[sid] not in holders(sid) or hit is None or \
                hit[0] != home[sid] or hit[1] > t_crash:
            raise AssertionError(
                f"serve-router sid={sid}: family indexed on "
                f"{holders(sid)}, placed on {home[sid]}, first radix hit "
                f"{hit}")
    if state["crashed"] is None:
        raise AssertionError("serve-router: replica b never crashed")
    if "tool" not in {p for p, _ in held.values()}:
        raise AssertionError("serve-router: no session in a tool at the crash")
    failed = [e for e in router.events if e["ev"] == "failed"]
    if [e["rid"] for e in failed] != ["b"]:
        raise AssertionError(f"serve-router: router events {router.events}")
    by_sid = {s.sid: s for s in sessions}
    V = get_config("llama3.2-1b").vocab_size
    if sorted(s.sid for s in finished) != sorted(by_sid):
        raise AssertionError(f"serve-router: {len(finished)} of "
                             f"{len(sessions)} sessions finished")
    for s in finished:
        gen = s.meta.get("generated", [])
        if len(gen) != sum(r.decode_tokens for r in s.rounds) or \
                not all(0 <= t < V for t in gen):
            raise AssertionError(f"serve-router sid={s.sid}: "
                                 f"{len(gen)} tokens")
    moved = [sid for sid in held if router.session_home[sid] == "a"]
    if sorted(moved) != sorted(held):
        raise AssertionError(f"serve-router: {held} not all re-placed on a")
    # the resume on a: each moved session prefilled its context again
    rec = {sid: sum(e.data.get("tokens", 0)
                    for e in both["a"].bus.of_kind(ev.PREFILL_CHUNK)
                    if e.sid == sid and e.t >= t_crash) for sid in held}
    log(f"[serve-router] tokens prefilled again on a after the crash "
        f"{rec}")
    if not all(rec.values()):
        raise AssertionError(f"serve-router: no recompute on a: {rec}")
    health = HealthReport.collect(router, detectors=detectors)
    log(f"[serve-router] after failover: requeued {len(held)} sessions to "
        f"a, all {len(finished)} finished in {wall:.3f}s; router stats "
        f"{json.dumps(router.stats())}")
    log(f"[serve-router] cluster_prefix_stats "
        f"{json.dumps(router.cluster_prefix_stats())}")
    log(f"[serve-router] health {health.status}:\n{health.render()}")
    if health.status != "critical":        # a dead replica: critical
        raise AssertionError(f"serve-router: health {health.status}")
    log(f"[serve-router] per-replica launches {json.dumps(per_replica)}")
    for rid in ("a", "b"):
        _require_paged(f"serve-router:{rid}", {
            name: per_replica[rid].get(name, 0) for name in KERNELS})
    _require_paged("serve-router", launches)
    return launches


RWKV_SERVE = dict(sessions=8, prompt=1024, decode=16, tool=64)


def _greedy(cfg, params, last, state, steps, start):
    """``steps`` greedy decode steps; returns (last logits, state, wall ms
    per step). Every step's logits must be finite."""
    ms = []
    for i in range(steps):
        tok = torch.argmax(last, -1).to(torch.int32)
        pos = torch.full_like(tok, start + i)
        t0 = time.monotonic()
        last, state = model_zoo.decode(cfg, params, state, tok, pos)
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        _finite(last, f"decode step {start + i}")
    return last, state, ms


def _finite(x, what):
    if not torch.isfinite(x).all():
        raise AssertionError(f"non-finite logits in {what}")


def phase_serve_rwkv():
    """rwkv6-1.6b at full width in bf16 through the port's model_zoo: one
    prefill of 8 sessions' 1,024-token prompts, 16 greedy decode steps, a
    64-token tool output per session resumed from the carried state, 16
    more steps. Every forward call launches wkv6 once per layer. Then the
    carried-state check in f32 at B = 1. Returns the launches and the
    weights (the rwkv profile runs on them)."""
    cfg = get_config("rwkv6-1.6b")
    S = RWKV_SERVE
    B, T, n_dec = S["sessions"], S["prompt"], S["decode"]
    t0 = time.monotonic()
    params = model_zoo.init(cfg, 0, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))
                               .astype(np.int32)).to(DEV)
    tools = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S["tool"]))
                             .astype(np.int32)).to(DEV)
    H = cfg.d_model // cfg.rwkv.head_size
    log(f"[serve-rwkv] rwkv6-1.6b full width (L={cfg.n_layers} "
        f"d={cfg.d_model} H={H} K={cfg.rwkv.head_size} d_ff={cfg.d_ff} "
        f"V={cfg.vocab_size}, {cfg.param_count() / 1e9:.3f} B params) bf16:"
        f" set-up {time.monotonic() - t0:.2f}s, device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.monotonic()
    last, state = model_zoo.prefill(cfg, params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    _finite(last, "serve-rwkv prefill")
    last, state, dec = _greedy(cfg, params, last, state, n_dec, T)
    t0 = time.monotonic()
    logits, state = rwkv6.rwkv_forward(cfg, params, tools, state=state,
                                       return_state=True)
    torch.cuda.synchronize()
    resume_ms = (time.monotonic() - t0) * 1e3
    _finite(logits, "serve-rwkv resume")
    last, state, dec2 = _greedy(cfg, params, logits[:, -1], state, n_dec,
                                T + n_dec + S["tool"])
    launches = _launch_counts()
    calls = 2 + 2 * n_dec
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = float(np.median(dec + dec2))
    log(f"[serve-rwkv] on {torch.cuda.get_device_name(0)}: prefill "
        f"{B}x{T} {prefill_ms:.2f} ms, resume {B}x{S['tool']} "
        f"{resume_ms:.2f} ms, decode step median {step_ms:.3f} ms "
        f"(min {min(dec + dec2):.3f}, max {max(dec + dec2):.3f}) = "
        f"{B / step_ms * 1e3:.1f} tokens/s; peak device memory {peak:.2f} "
        f"GB")
    log(f"[serve-rwkv] kernel launches: {launches} ({calls} forward calls "
        f"x {cfg.n_layers} layers = {calls * cfg.n_layers})")
    if launches["wkv6"] != calls * cfg.n_layers:
        raise AssertionError("serve-rwkv: wkv6 launches != layers x calls")
    for name, n in launches.items():
        if name not in RWKV_PATH and n:
            raise AssertionError(f"serve-rwkv: {name} ran")
    _carried_state_check(cfg, params, prompts[:1], tools[:1])
    return launches, params


CARRY_TOL = 1e-3                 # x the largest |logit| (at least 1)


def _carried_state_check(cfg, params, prompt, tool):
    """f32, B = 1: prefill(prompt) then a forward resumed from its state
    over ``tool`` gives the logits of one prefill over both, at every
    resumed position, and the same last argmax. MARS keeps an rwkv
    session's state across a tool call on this property. The two runs
    differ only in the row counts cuBLAS sees, so they sum in other
    orders, and 24 layers amplify that: the same recompute at B = 2 (a
    duplicated row) measures this noise floor, logged beside the error.
    Tolerance 1e-3 of the largest logit; a state that is not carried
    (zeroed, stale, another session's) is off by the logits' own scale."""
    p32 = _tree_map(lambda t: t.float(), params)
    _, st = rwkv6.rwkv_prefill(cfg, p32, prompt)
    resumed = rwkv6.rwkv_forward(cfg, p32, tool, state=st)
    seq = torch.cat([prompt, tool], 1)
    n = prompt.shape[1]
    want = rwkv6.rwkv_forward(cfg, p32, seq)[:, n:]
    twin = rwkv6.rwkv_forward(cfg, p32, torch.cat([seq, seq]))[:1, n:]
    err = (resumed - want).abs().max().item()
    noise = (twin - want).abs().max().item()
    tol = CARRY_TOL * max(1.0, want.abs().max().item())
    same = bool(torch.equal(torch.argmax(resumed[:, -1], -1),
                            torch.argmax(want[:, -1], -1)))
    log(f"[serve-rwkv] carried state, f32 B=1: prefill({n}) + "
        f"resume({tool.shape[1]}) vs prefill({seq.shape[1]}): max abs err "
        f"{err:.3e} over the {tool.shape[1]} resumed positions (tol "
        f"{tol:.3e}; noise floor, the same prefill at B=2: {noise:.3e}), "
        f"last argmax equal: {same}")
    if not err <= tol or not same:
        raise AssertionError("serve-rwkv: carried state != recompute")


# ---------------------------------------------------------------------------
# the zamba2 (Mamba2 + shared attention) and whisper (encoder-decoder)
# families through model_zoo: card vs CPU at .reduced(), then full width
# ---------------------------------------------------------------------------

def _cache_fields(cache, prefix=""):
    """(name, tensor) of every field of a (nested) cache dataclass."""
    out = []
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        out += _cache_fields(v, f"{prefix}{f.name}.") \
            if dataclasses.is_dataclass(v) else [(prefix + f.name, v)]
    return out


def _padded(cfg, cache, max_len):
    """A prefill cache (its K/V exactly as long as the prompt, as in JAX)
    copied into zeros of ``max_len`` positions, where a decode step has
    room to write; the Mamba states and the cross K/V are carried over."""
    if cfg.family == "zamba2":
        B, T = cache.k.shape[1:3]
        out = model_zoo.cache_zeros(cfg, B, max_len, cache.k.dtype,
                                    device=cache.k.device)
        out.k[:, :, :T], out.v[:, :, :T] = cache.k, cache.v
        out.mamba = cache.mamba
        return out
    B, T = cache.self_k.shape[1:3]
    out = model_zoo.cache_zeros(cfg, B, max_len, cache.self_k.dtype,
                                enc_len=cache.cross_k.shape[2],
                                device=cache.self_k.device)
    out.self_k[:, :, :T], out.self_v[:, :, :T] = cache.self_k, cache.self_v
    out.cross_k, out.cross_v = cache.cross_k, cache.cross_v
    return out


def _flash_calls(cfg) -> int:
    """flash_attention launches of one forward or prefill: one per shared
    block application (zamba2); per encoder layer, and twice per decoder
    layer (self- and cross-attention) for whisper."""
    if cfg.family == "zamba2":
        return len(zamba2.shared_positions(cfg))
    return cfg.n_enc_layers + 2 * cfg.n_layers


def _ssm_batch(cfg, rng, B, T, frames=40):
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32))}
    if cfg.family == "whisper":
        batch["frames"] = torch.from_numpy((rng.standard_normal(
            (B, frames, cfg.d_model)) * 0.1).astype(np.float32))
    return batch


def phase_model_ssm() -> None:
    """zamba2-1.2b and whisper-tiny .reduced(), f32, the same weights on
    the card (flash kernel) and on the CPU (plain version): forward,
    prefill and a decode step from the prefill's cache padded by 8
    positions. Logits and every cache field within MODEL_TOL of the
    tensor's largest magnitude (at least 1), next tokens equal;
    flash_attention launched ``_flash_calls`` times by each forward and
    prefill on the card and never by the decode step."""
    for arch in ("zamba2-1.2b", "whisper-tiny"):
        cfg = get_config(arch).reduced()
        params = model_zoo.init(cfg, 0, torch.float32, device="cpu")
        dparams = _to_device(params)
        rng = np.random.default_rng(6)
        B, T = 2, 32
        batch = _ssm_batch(cfg, rng, B, T)
        dbatch = {k: v.to(DEV) for k, v in batch.items()}
        worst = 0.0

        def agree(got, want, what):
            nonlocal worst
            scale = max(1.0, want.float().abs().max().item())
            err = (got.float().cpu() - want.float()).abs().max().item()
            worst = max(worst, err / scale)
            if not err <= MODEL_TOL * scale:
                raise AssertionError(f"model-ssm {arch} {what}: max abs err "
                                     f"{err} of the magnitude {scale}")

        def caches(got, want, what):
            for (name, g), (_, w) in zip(_cache_fields(got),
                                         _cache_fields(want)):
                agree(g, w, f"{what} {name}")

        def same_next(got, want, what):
            if torch.argmax(got, -1).cpu().tolist() != \
                    torch.argmax(want, -1).tolist():
                raise AssertionError(f"model-ssm {arch} {what}: next tokens "
                                     "differ")

        before = _launches("flash_attention")
        agree(model_zoo.forward(cfg, dparams, dbatch),
              model_zoo.forward(cfg, params, batch), "forward logits")
        lg, cg = model_zoo.prefill(cfg, dparams, dbatch)
        lc, cc = model_zoo.prefill(cfg, params, batch)
        agree(lg, lc, "prefill logits")
        caches(cg, cc, "prefill")
        same_next(lg, lc, "prefill")
        launched = _launches("flash_attention") - before
        cg, cc = _padded(cfg, cg, T + 8), _padded(cfg, cc, T + 8)
        nxt = torch.argmax(lc, -1).to(torch.int32)
        pos = torch.full((B,), T, dtype=torch.int32)
        lc, cc = model_zoo.decode(cfg, params, cc, nxt, pos)
        lg, cg = model_zoo.decode(cfg, dparams, cg, nxt.to(DEV), pos.to(DEV))
        agree(lg, lc, "decode logits")
        caches(cg, cc, "decode")
        same_next(lg, lc, "decode")
        total = _launches("flash_attention") - before
        if launched != 2 * _flash_calls(cfg) or total != launched:
            raise AssertionError(f"model-ssm {arch}: flash_attention "
                                 f"launched {launched} times by forward and "
                                 f"prefill, {total} in all; expected "
                                 f"{2 * _flash_calls(cfg)}")
        log(f"[model] {arch} reduced f32: card vs cpu max abs err "
            f"{worst:.3e} of the largest magnitude (tol {MODEL_TOL}) over "
            f"the logits and {len(_cache_fields(cc))} cache fields; next "
            f"tokens equal; flash_attention launched {launched} times "
            f"(forward and prefill), none in the decode step")


ZAMBA_SERVE = dict(sessions=8, prompt=1024, pad=1056, decode=16)
WHISPER_SERVE = dict(sessions=8, frames=1500, prompt=4, to=64, pad=448)
# f32, B = 1: prefill(S) then D - 1 teacher-forced decode steps against one
# forward over S + D tokens (zamba2: 15 SSD chunks of 64, then 64 steps
# that end on a chunk boundary of the forward)
ZAMBA_CHECK = dict(S=960, D=64)
WHISPER_CHECK = dict(S=4, D=60)


def _decode_vs_forward(label, cfg, params, tokens, S, frames=None):
    """f32, B = 1: prefill(tokens[:, :S]) then teacher-forced decode steps
    over the rest of ``tokens`` (from the padded cache) give one forward's
    logits over the whole of ``tokens`` at every decoded position; the
    first is ``forward(S + 1)``'s last logits (causality). This holds the
    chunked SSD (zamba2) and the flash attentions (both) against their
    one-step forms at full width. Tolerance CARRY_TOL of the largest
    logit; the same argmax at the first decoded position, and at every
    other one whose top two logits differ by more than twice its error
    (closer ties counted)."""
    p32 = _tree_map(lambda t: t.float(), params)
    N = tokens.shape[1]
    extra = {} if frames is None else {"frames": frames.float()}
    want = model_zoo.forward(cfg, p32, {"tokens": tokens, **extra})[0]
    last, cache = model_zoo.prefill(cfg, p32, {"tokens": tokens[:, :S],
                                              **extra})
    cache = _padded(cfg, cache, N)
    got = [last[0]]
    for i in range(S, N - 1):
        last, cache = model_zoo.decode(
            cfg, p32, cache, tokens[:, i],
            torch.full((1,), i, dtype=torch.int32, device=DEV))
        got.append(last[0])
    got, want = torch.stack(got), want[S - 1:N - 1]
    err_row = (got - want).abs().amax(-1)
    err = err_row.max().item()
    tol = CARRY_TOL * max(1.0, want.abs().max().item())
    top = torch.topk(want, 2, -1).values
    decided = top[:, 0] - top[:, 1] > 2 * err_row
    decided[0] = True
    same = torch.equal(got.argmax(-1)[decided], want.argmax(-1)[decided])
    log(f"[{label}] f32 B=1: prefill({S}) + {N - S - 1} decode steps vs "
        f"forward({N}): max abs err {err:.3e} over {N - S} positions (tol "
        f"{tol:.3e}; largest |logit| {want.abs().max().item():.3f}; at the "
        f"first, forward({S + 1})'s last: {err_row[0].item():.3e}); argmax "
        f"equal: {same} ({int((~decided).sum())} near ties not compared)")
    if not err <= tol or not same:
        raise AssertionError(f"{label}: decode steps != forward")


def _param_count(params) -> int:
    return sum(t.numel() for _, t in _named_leaves(params))


def phase_serve_zamba():
    """zamba2-1.2b at full width in bf16 through model_zoo: one prefill of
    8 sessions' 1,024-token prompts (flash_attention launched exactly once
    per shared block application, 6, and no other kernel), the cache
    padded to 1,056, 16 greedy decode steps (plain attention: no kernel),
    every logit finite; then _decode_vs_forward in f32. Returns the
    launches and the weights (the zamba2 profile runs on them)."""
    cfg = get_config("zamba2-1.2b")
    S = ZAMBA_SERVE
    B, T, n_dec = S["sessions"], S["prompt"], S["decode"]
    t0 = time.monotonic()
    params = model_zoo.init(cfg, 0, torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    s = cfg.ssm
    n_apps = len(zamba2.shared_positions(cfg))
    log(f"[serve-zamba] zamba2-1.2b full width (L={cfg.n_layers} Mamba2 "
        f"d={cfg.d_model} d_inner={s.d_inner(cfg.d_model)} "
        f"H={s.n_heads(cfg.d_model)} P={s.head_dim} N={s.d_state} chunk "
        f"{s.chunk_size}; shared block x{n_apps}: Hq=Hkv={cfg.n_heads} "
        f"D={cfg.head_dim_} d_ff={cfg.d_ff}; V={cfg.vocab_size}; "
        f"{_param_count(params) / 1e9:.3f} B params counted) bf16: set-up "
        f"{time.monotonic() - t0:.2f}s, device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))
                               .astype(np.int32)).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.monotonic()
    last, cache = model_zoo.prefill(cfg, params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    launches = _launch_counts()
    _finite(last, "serve-zamba prefill")
    last, cache, dec = _greedy(cfg, params, last,
                               _padded(cfg, cache, S["pad"]), n_dec, T)
    after = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = float(np.median(dec))
    log(f"[serve-zamba] on {torch.cuda.get_device_name(0)}: prefill {B}x{T}"
        f" {prefill_ms:.2f} ms ({B * T / prefill_ms * 1e3:.0f} tokens/s), "
        f"decode step median {step_ms:.3f} ms (min {min(dec):.3f}, max "
        f"{max(dec):.3f}) = {B / step_ms * 1e3:.1f} tokens/s over {B} "
        f"sessions; peak device memory {peak:.2f} GB")
    log(f"[serve-zamba] kernel launches in the prefill: {launches} "
        f"({n_apps} shared block applications); after {n_dec} decode "
        f"steps: {after}")
    if launches["flash_attention"] != n_apps or after != launches:
        raise AssertionError("serve-zamba: flash_attention launches != "
                             "shared block applications, or a decode step "
                             "launched a kernel")
    for name, n in launches.items():
        if name not in DENSE_PATH and n:
            raise AssertionError(f"serve-zamba: {name} ran")
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, sum(ZAMBA_CHECK.values()))).astype(
            np.int32)).to(DEV)
    _decode_vs_forward("serve-zamba", cfg, params, toks, ZAMBA_CHECK["S"])
    return launches, params


@contextlib.contextmanager
def _ssd_ranges():
    """Profiler ranges around the SSD scan (``ssd_chunked``) and its
    one-step form (``ssd_step``), which the Mamba blocks look up at call
    time; restored on exit."""
    from torch.profiler import record_function
    orig = mamba2.ssd_chunked, mamba2.ssd_step

    def ranged(name, fn):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call
    mamba2.ssd_chunked = ranged("ssd_chunked", orig[0])
    mamba2.ssd_step = ranged("ssd_step", orig[1])
    try:
        yield
    finally:
        mamba2.ssd_chunked, mamba2.ssd_step = orig


def phase_profile_zamba(params) -> None:
    """One full-width zamba2 prefill (B 8, T 1,024) and one decode step of
    the 8 sessions, on the serve's weights: wall, device time, idle share,
    the SSD scan's and the flash kernel's shares of the device time."""
    cfg = get_config("zamba2-1.2b")
    B, T = ZAMBA_SERVE["sessions"], ZAMBA_SERVE["prompt"]
    n_apps = len(zamba2.shared_positions(cfg))
    toks = torch.zeros((B, T), dtype=torch.int32, device=DEV)
    # the prefill launches ~18k kernels: one traced call (the profiler's
    # digest of three took a minute)
    for label, fn, ssd, traced in (
            (f"zamba2 prefill B={B} T={T} ({n_apps} flash_attention "
             f"launches)",
             lambda: model_zoo.prefill(cfg, params, {"tokens": toks}),
             "ssd_chunked", 1),
            (f"zamba2 decode step B={B}", None, "ssd_step", 3)):
        if fn is None:
            _, cache = model_zoo.prefill(cfg, params, {"tokens": toks})
            cache = _padded(cfg, cache, ZAMBA_SERVE["pad"])
            tok = torch.zeros((B,), dtype=torch.int32, device=DEV)
            pos = torch.full((B,), T, dtype=torch.int32, device=DEV)

            def fn(cache=cache, tok=tok, pos=pos):
                return model_zoo.decode(cfg, params, cache, tok, pos)
        _, total, flash, parts = _profile(label, fn, traced=traced,
                                          focus="flash", labels=(ssd,),
                                          traced_ctx=_ssd_ranges)
        log(f"[profile] {label}: SSD scan ({ssd}) {parts[ssd]:.3f} ms, "
            f"share of device time {parts[ssd] / max(total, 1e-9):.3f}; "
            f"flash_attention {flash:.3f} ms, share "
            f"{flash / max(total, 1e-9):.3f}")


def phase_serve_whisper():
    """whisper-tiny at full width in bf16 through model_zoo: 8 sessions of
    1,500 encoder frames (Whisper's 30 s window after its stride-2
    convolution; the stub front end's embeddings, seeded normal x 0.01)
    and a 4-token decoder prompt in one prefill (flash_attention launched
    exactly 12 times: 4 encoder layers, self- and cross-attention in 4
    decoder layers), then greedy decode to 64 tokens in a self cache
    padded to 448 (plain attention: no kernel), every logit finite; then
    _decode_vs_forward in f32 on the first session's frames."""
    cfg = get_config("whisper-tiny")
    S = WHISPER_SERVE
    B, T = S["sessions"], S["prompt"]
    t0 = time.monotonic()
    params = model_zoo.init(cfg, 0, torch.bfloat16, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(3)
    frames = (torch.randn((B, S["frames"], cfg.d_model), generator=gen,
                          device=DEV) * 0.01).to(torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[serve-whisper] whisper-tiny full width (encoder {cfg.n_enc_layers}"
        f" x decoder {cfg.n_layers} layers, d={cfg.d_model} H={cfg.n_heads} "
        f"D={cfg.head_dim_} d_ff={cfg.d_ff} V={cfg.vocab_size}; "
        f"{_param_count(params) / 1e6:.2f} M params counted) bf16: set-up "
        f"{time.monotonic() - t0:.2f}s")
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))
                              .astype(np.int32)).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.monotonic()
    last, cache = model_zoo.prefill(cfg, params, {"tokens": prompt,
                                                  "frames": frames})
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    launches = _launch_counts()
    _finite(last, "serve-whisper prefill")
    last, cache, dec = _greedy(cfg, params, last,
                               _padded(cfg, cache, S["pad"]), S["to"] - T, T)
    after = _launch_counts()
    step_ms = float(np.median(dec))
    log(f"[serve-whisper] on {torch.cuda.get_device_name(0)}: prefill "
        f"(encoder {B}x{S['frames']} frames + decoder {B}x{T}) "
        f"{prefill_ms:.2f} ms, decode step median {step_ms:.3f} ms (min "
        f"{min(dec):.3f}, max {max(dec):.3f}) = {B / step_ms * 1e3:.1f} "
        f"tokens/s over {B} sessions to {S['to']} tokens; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"[serve-whisper] kernel launches in the prefill: {launches}; after "
        f"{S['to'] - T} decode steps: {after}")
    if launches["flash_attention"] != _flash_calls(cfg) or after != launches:
        raise AssertionError("serve-whisper: flash_attention launches != "
                             f"{_flash_calls(cfg)} in the prefill, or a "
                             "decode step launched a kernel")
    for name, n in launches.items():
        if name not in DENSE_PATH and n:
            raise AssertionError(f"serve-whisper: {name} ran")
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, sum(WHISPER_CHECK.values()))).astype(
            np.int32)).to(DEV)
    _decode_vs_forward("serve-whisper", cfg, params, toks,
                       WHISPER_CHECK["S"], frames=frames[:1])
    return launches


MOE_SERVE = dict(jobs=8, shared_tokens=1024, tail_chunks=(2, 3, 4, 2),
                 decode=16, total_pages=1024, token_budget=256)


def _moe_jobs(run: int, V: int):
    """The 8 jobs of a MoE serve run, in the shapes of ``_sessions``: two
    families whose round-0 prompts share a 1,024-token prefix, a private
    tail of 2-4 chunks plus 16 tokens, then 48- and 32-token rounds, two
    sleep tools of 0.2-0.5 s. Per job: (job_id, [3 prompts], [2 tool
    seconds], prefix-hash keys of the round-0 prompt)."""
    rng = np.random.default_rng(200 + run)
    shared = [rng.integers(2, V, MOE_SERVE["shared_tokens"]).tolist()
              for _ in range(2)]
    jobs = []
    for i in range(MOE_SERVE["jobs"]):
        fam, tail = i % 2, MOE_SERVE["tail_chunks"][i % 4]
        first = shared[fam] + rng.integers(2, V, 32 * tail + 16).tolist()
        prompts = [first, rng.integers(2, V, 48).tolist(),
                   rng.integers(2, V, 32).tolist()]
        hashes = [(("moe-fam", run, fam, c), 32)
                  for c in range(MOE_SERVE["shared_tokens"] // 32)] + \
            [(("moe-u", run, i, c), 32) for c in range(tail)] + \
            [(("moe-u", run, i, "part"), 16)]
        jobs.append((f"job-{run}-{i}", prompts,
                     rng.uniform(0.2, 0.5, 2).tolist(), hashes))
    return jobs


def _serve_api(backend, run: int, *, force_offload: bool):
    """One Engine run under MARS driven through ``ServingAPI``: each job's
    round-0 request goes in at once, and each later request under the same
    ``job_id`` when the job's previous response arrives (its future's
    callback), as an agent sends its next turn. The round-0 prompts carry
    their prefix-hash keys (a family's shared system prompt and history
    are one radix prefix). Checks that every future resolves with 16
    in-vocabulary tokens and a TTFT; under MARS that every job's second
    round resumes warm (its KV pinned through the tool); under forced
    OFFLOAD that a host swap-out happened."""
    label = "offload" if force_offload else "mars"
    V, d = backend.cfg.vocab_size, MOE_SERVE["decode"]
    bus = EventBus()
    tools = RealToolExecutor(cpu_slots=4, bus=bus)
    eng = Engine(EngineConfig(total_kv_blocks=MOE_SERVE["total_pages"],
                              block_size=32,
                              token_budget=MOE_SERVE["token_budget"],
                              max_decode_batch=8, cpu_slots=4,
                              scheduler="mixed"),
                 "mars", backend, bus=bus, tool_exec=tools)
    if force_offload:
        eng.policy.on_tool_yield = lambda s, now: (KVAction.OFFLOAD, 0.0)
    api = ServingAPI(eng)
    futures = {}

    def request(job, r):
        job_id, prompts, tool_s, _ = job
        final = r == len(prompts) - 1
        fut = api.submit(ChatRequest(
            job_id=job_id, prompt_tokens=prompts[r], max_tokens=d,
            tool_call=None if final else {"kind": "sleep",
                                          "seconds": tool_s[r]},
            final=final))
        futures[job_id, r] = fut
        if not final:
            def next_request(f):
                if f.exception() is None:
                    request(job, r + 1)
            fut.add_done_callback(next_request)

    jobs = _moe_jobs(run, V)
    for job in jobs:
        request(job, 0)
        api._jobs[job[0]].meta["prefix_hashes"] = list(job[3])
    try:
        t0 = time.monotonic()
        run_live(eng, [], timeout=300)
        wall = time.monotonic() - t0
    finally:
        tools.shutdown()
    eng.check_invariants()
    for job_id, prompts, _, _ in jobs:
        s = api._jobs[job_id]
        res = []
        for r in range(len(prompts)):
            fut = futures.get((job_id, r))
            if fut is None or not fut.done():
                raise AssertionError(f"serve-moe[{label}] {job_id}: round "
                                     f"{r} never resolved")
            res.append(fut.result())
            toks = res[-1]["tokens"]
            if len(toks) != d or not all(0 <= t < V for t in toks) or \
                    res[-1]["round"] != r or res[-1]["ttft"] is None:
                raise AssertionError(f"serve-moe[{label}] {job_id} round "
                                     f"{r}: bad result {res[-1]}")
        mine = [e for e in bus.log if e.sid == s.sid]
        warm = any(a.kind == ev.UNPIN and a.data.get("warm")
                   and b.kind == ev.GPU_SUBMIT and b.data.get("round") == 1
                   for a, b in zip(mine, mine[1:]))
        if not force_offload and not warm:
            raise AssertionError(f"serve-moe[mars] {job_id}: the second "
                                 "round did not resume warm")
        log(f"[serve-moe:{label}] {job_id} sid={s.sid} e2e="
            f"{s.e2e_latency:.3f}s ttfts={[round(x['ttft'], 4) for x in res]}"
            f" warm_round1={warm}")
    if api.active_jobs():
        raise AssertionError(f"serve-moe[{label}]: jobs still active")
    outs = [e for e in bus.log if e.kind == ev.SWAP_OUT
            and e.data.get("tier") == "host"]
    log(f"[serve-moe:{label}] finished {len(eng.finished)}/{len(jobs)} jobs "
        f"in {wall:.2f}s wall, prefix_hit_tokens={eng.prefix_hit_tokens}, "
        f"host swap-outs={len(outs)}, cow={eng.blocks.cow_count}")
    if len(eng.finished) != len(jobs):
        raise AssertionError(f"serve-moe[{label}]: {len(eng.finished)} of "
                             f"{len(jobs)} jobs finished")
    if force_offload and not outs:
        raise AssertionError("serve-moe[offload]: no host SWAP_OUT")


def phase_serve_moe():
    """Full-width qwen3-coder-30b-a3b (48 layers, 128 experts top-8, Hq 32,
    Hkv 4, D 128) in bf16, random weights from seed 0, on the paged layout
    (1,024 pages of 32), driven through ServingAPI over Engine(scheduler=
    "mixed") under MARS, then with every tool yield forced to OFFLOAD.
    Launch counters zeroed after the backend is built (calibrate runs the
    model), read after both runs: both paged kernels must launch. Returns
    the MoE launches and the backend (its weights and pool feed the MoE
    profile)."""
    cfg = QWEN3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    backend = TorchBackend(cfg, device=DEV, dtype=torch.bfloat16, seed=0,
                           total_pages=MOE_SERVE["total_pages"],
                           page_size=32, max_slots=8)
    torch.cuda.synchronize()
    if backend.layout != "paged":
        raise AssertionError(f"qwen3 took the {backend.layout} layout")
    m = cfg.moe
    log(f"[serve-moe] qwen3-coder-30b-a3b full width (L={cfg.n_layers} "
        f"d={cfg.d_model} Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} "
        f"Dh={cfg.head_dim_} E={m.num_experts} top-{m.top_k} "
        f"F={m.d_ff_expert} V={cfg.vocab_size}) bf16, "
        f"{MOE_SERVE['total_pages']} pages of 32: set-up "
        f"{time.monotonic() - t0:.2f}s, device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; calibrated prefill "
        f"{1.0 / backend.prefill_rate() * 1e6:.1f} us/token, decode step "
        f"{backend._decode_s_per_step * 1e3:.2f} ms")
    _zero_launches()
    try:
        _serve_api(backend, 0, force_offload=False)
        _serve_api(backend, 1, force_offload=True)
    except BaseException:
        backend.close()
        raise
    launches = _launch_counts()
    st = backend.dispatch_stats
    log(f"[serve-moe] on {torch.cuda.get_device_name(0)}: dispatch_stats "
        + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in st.items()}))
    log(f"[serve-moe] swap_stream {json.dumps(backend.swap_stream_stats())}"
        f"; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB")
    log(f"[serve-moe] kernel launches on the MoE main path: {launches}")
    if st["mixed_calls"] <= 0:
        raise AssertionError("serve-moe: no mixed iteration ran")
    for name in MAIN_PATH:
        if launches[name] <= 0:
            backend.close()
            raise AssertionError(f"serve-moe: {name} never launched")
    return launches, backend


DENSE_SERVE = dict(prompts=(4608, 4608, 1024, 1024), decode=16, slots=4,
                   max_len=6144)


def _dense_sessions(run: int):
    """Two round-0 prompts past gemma2's 4,096-token window (the local
    layers mask keys in their later chunks and in every decode step) and
    two of 1,024, arriving 0.1 s apart; then 48- and 32-token rounds."""
    rng = np.random.default_rng(100 + run)
    out = []
    for i, first in enumerate(DENSE_SERVE["prompts"]):
        tools = rng.uniform(0.2, 0.5, 2)
        d = DENSE_SERVE["decode"]
        rounds = [Round(first, d, "sleep", float(tools[0])),
                  Round(48, d, "sleep", float(tools[1])),
                  Round(32, d, None, 0.0)]
        out.append(make_session(0.1 * i, rounds, ideal_time=10.0))
    return out


def phase_serve_dense():
    """gemma2-27b at full width on the dense slot layout; returns the
    kernel launches of both runs and the backend (its weights and cache
    feed the dense profile)."""
    cfg = get_config("gemma2-27b")
    t0 = time.monotonic()
    backend = TorchBackend(cfg, device="cuda", dtype=torch.bfloat16, seed=0,
                           max_slots=DENSE_SERVE["slots"],
                           max_len=DENSE_SERVE["max_len"])
    torch.cuda.synchronize()
    if backend.layout != "dense":
        raise AssertionError(f"gemma2 took the {backend.layout} layout")
    log(f"[serve-dense] gemma2-27b full width (L={cfg.n_layers} "
        f"d={cfg.d_model} Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} "
        f"Dh={cfg.head_dim_} V={cfg.vocab_size} window={cfg.sliding_window})"
        f" bf16, dense layout {DENSE_SERVE['slots']} slots x "
        f"{DENSE_SERVE['max_len']} tokens: set-up "
        f"{time.monotonic() - t0:.2f}s, device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; calibrated prefill "
        f"{1.0 / backend.prefill_rate() * 1e6:.1f} us/token, decode step "
        f"{backend._decode_s_per_step * 1e3:.2f} ms, host link "
        f"{backend._h2d_bw / 1e9:.2f} GB/s")
    # zeroed after the backend is built: calibrate runs lm_step too
    _zero_launches()
    st = backend.dispatch_stats
    calls0 = st["prefill_calls"]
    ecfg = dict(total_kv_blocks=DENSE_SERVE["slots"]
                * (DENSE_SERVE["max_len"] - 1) // 32, block_size=32,
                token_budget=512, max_decode_batch=DENSE_SERVE["slots"],
                cpu_slots=4, scheduler="mixed")
    try:
        _serve(backend, _dense_sessions(0), ecfg, force_offload=False)
        _serve(backend, _dense_sessions(1), ecfg, force_offload=True)
    except BaseException:
        backend.close()
        raise
    launches = _launch_counts()
    n_prefill = st["prefill_calls"] - calls0
    log(f"[serve-dense] on {torch.cuda.get_device_name(0)}: dispatch_stats "
        + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in st.items()}))
    log(f"[serve-dense] prefill_s {st['prefill_s']:.3f}s over "
        f"{st['prefill_calls']} calls, decode_s {st['decode_s']:.3f}s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB; swap_stream {backend.swap_stream_stats()}")
    log(f"[serve-dense] kernel launches on the dense path: {launches} "
        f"({n_prefill} prefill calls x {cfg.n_layers} layers = "
        f"{n_prefill * cfg.n_layers})")
    if st["mixed_calls"] != 0:
        raise AssertionError("serve-dense: the dense layout ran run_mixed")
    for name in DENSE_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"serve-dense: {name} never launched")
    if launches["flash_attention"] != cfg.n_layers * n_prefill:
        raise AssertionError("serve-dense: flash_attention launches != "
                             "layers x prefill calls")
    for name in MAIN_PATH:
        if launches[name] != 0:
            raise AssertionError(f"serve-dense: paged kernel {name} ran")
    return launches, backend


# ---------------------------------------------------------------------------
# 6. timing at main-path shapes
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, key: str, iters: int = 50) -> float:
    """Device time per call of the kernels whose name holds ``key`` (all
    of the call's kernels for ``""``), from the profiler's CUDA trace
    (CUPTI), warmed. For a launch shorter than
    its wrapper's host cost, CUDA events around a Python loop time the
    host's enqueue instead of the kernel. The trace can miss kernel
    records (on an H100 80GB HBM3 host: one in a 50-call trace as a rule,
    once most of them, once all of them), so the time is the mean of the
    records it holds times the kernels a call launches, not their sum over
    the calls, and a trace that holds none is taken again, up to three
    times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if key in e.key
               and "CUDA" in str(getattr(e, "device_type", ""))]
        total = sum(e.device_time_total for e in evs)
        n = sum(e.count for e in evs)
        if total > 0:
            break
        log(f"[timing] device_ms({key!r}): no kernel record in the trace "
            f"of {iters} calls (trace {attempt} of 3)")
    else:
        raise AssertionError(f"no device time for {key} in three traces")
    per_call = max(1, round(n / iters))
    if n != per_call * iters:
        log(f"[timing] device_ms({key!r}): {n} kernel records for {iters} "
            f"calls of {per_call} kernel(s); the mean record counts")
    return total / n * per_call / 1e3


def _bound(nbytes: float, flops: float, peak: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _dense_kv(pages, table):
    """(B, Hkv, Np*page, D) dense copy of the table's pages (for SDPA)."""
    B, Np = table.shape
    _, page, Hkv, D = pages.shape
    return pages[table.long()].reshape(B, Np * page, Hkv, D).transpose(1, 2)


def _cycle(fns):
    """A callable that calls the next of ``fns`` each time, round robin:
    where the sets of inputs together exceed the card's 50 MB L2, every
    call finds its inputs cold, as a model layer finds its KV."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


ROTATION = 6        # decode tables over disjoint pages: 6 x ~20 MB of KV


def _decode_rows(gen, F, Hkv=8, D=64,
                 names=("paged_attention_fused", "paged_attention"),
                 long_lane=True):
    """The decode kernels ``names`` at the main path (8 lanes at
    1,090-1,377, Hq 32, Hkv 8, D 64, page 32, bf16; Qwen3-Coder's Hkv 4,
    D 128 when asked), each call on the next of ROTATION tables over
    disjoint pages of one 4,096-page pool, and SDPA on the next of as many
    dense copies (cold L2); with ``long_lane`` also the 16,384-token lane
    (else None)."""
    bf16, item = torch.bfloat16, 2
    B, Hq, page, maxp, P = 8, 32, 32, 64, 4096
    lens = torch.tensor(MAIN_LENS, device=DEV).int()
    q, kp, vp, _, lens = _decode_case(gen, B, Hq, Hkv, D, page, P, maxp,
                                      bf16, lengths=lens)
    k_new = _randn(gen, (B, Hkv, D), bf16)
    v_new = _randn(gen, (B, Hkv, D), bf16)
    perm = torch.randperm(P, generator=gen, device=DEV)
    tables = [perm[r * B * maxp:(r + 1) * B * maxp].reshape(B, maxp).int()
              .contiguous() for r in range(ROTATION)]
    slots = [_fused_slots(t, lens, page) for t in tables]
    for wp, wo in slots:     # the slots hold the new tokens, so every
        kp[wp.long(), wo.long()] = k_new     # version sees the same pool
        vp[wp.long(), wo.long()] = v_new
    dense = [(_dense_kv(kp, t), _dense_kv(vp, t)) for t in tables]
    mask = (torch.arange(maxp * page, device=DEV)[None]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    n_kv = float(lens.sum().item())
    libs = [lambda kd=kd, vd=vd: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask, enable_gqa=True)[:, :, 0]
        for kd, vd in dense]
    rows = []
    for name in names:
        fused = name == "paged_attention_fused"
        if fused:
            calls = [lambda t=t, wp=wp, wo=wo: paged_attention_fused(
                q, kp, vp, t, lens, k_new, v_new, wp, wo)[0]
                for t, (wp, wo) in zip(tables, slots)]

            def plain(t, wp, wo):
                kp[wp.long(), wo.long()] = k_new
                vp[wp.long(), wo.long()] = v_new
                return ref.paged_attention_ref(q, kp, vp, t, lens)
            plains = [lambda t=t, wp=wp, wo=wo: plain(t, wp, wo)
                      for t, (wp, wo) in zip(tables, slots)]
            kv_read = n_kv - B
        else:
            calls = [lambda t=t: paged_attention(q, kp, vp, t, lens)
                     for t in tables]
            plains = [lambda t=t: ref.paged_attention_ref(q, kp, vp, t, lens)
                      for t in tables]
            kv_read = n_kv
        nbytes = (2 * kv_read * Hkv * D * item + 2 * B * Hq * D * item
                  + (4 * B * Hkv * D * item if fused else 0)
                  + tables[0].numel() * 4 + B * 4 * (3 if fused else 1))
        rows.append(dict(name=name, run=_cycle(calls), plain=_cycle(plains),
                         lib=_cycle(libs), warm=calls[0], warm_lib=libs[0],
                         nbytes=nbytes, flops=4.0 * n_kv * Hq * D,
                         key="paged_decode"))
    if not long_lane:
        return rows, None
    return rows, _long_lane(q[:1], kp, vp, k_new[:1], v_new[:1], tables, F)


def _long_lane(q, kp, vp, k_new, v_new, tables, F):
    """One lane of 16,384 tokens (maxp 512) through paged_attention_fused,
    each call on the next of three 512-page tables (the pages of three
    main-path tables, 3 x 33.5 MB), beside SDPA over the same keys."""
    page, Hkv, D = kp.shape[1], kp.shape[2], kp.shape[3]
    n = 512 * page
    lens = torch.tensor([n], device=DEV).int()
    ltables = [t.reshape(1, -1).contiguous() for t in tables[:3]]
    slots = [_fused_slots(t, lens, page) for t in ltables]
    for wp, wo in slots:
        kp[wp.long(), wo.long()] = k_new
        vp[wp.long(), wo.long()] = v_new
    dense = [(_dense_kv(kp, t), _dense_kv(vp, t)) for t in ltables]
    calls = [lambda t=t, wp=wp, wo=wo: paged_attention_fused(
        q, kp, vp, t, lens, k_new, v_new, wp, wo)[0]
        for t, (wp, wo) in zip(ltables, slots)]
    libs = [lambda kd=kd, vd=vd: F.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, enable_gqa=True)[:, :, 0]
        for kd, vd in dense]
    nbytes = (2 * (n - 1) * Hkv * D * 2 + 2 * q.numel() * 2
              + 4 * Hkv * D * 2 + 512 * 4 + 12)
    return dict(run=_cycle(calls), lib=_cycle(libs), check=(calls[0],
                                                             libs[0]),
                nbytes=nbytes, flops=4.0 * n * q.shape[1] * D)


def _prefill_row(gen, F, Hkv=8, D=64):
    """paged_flash_attention on a prefill pack as the serve phases see
    it (C 256 at q_offset 1,024, Hq 32, bf16), the plain version and SDPA
    over a dense copy of the same keys."""
    bf16, item = torch.bfloat16, 2
    Hq, page, P = 32, 32, 4096
    C, Np, q_off = 256, 64, 1024
    kv_len = q_off + C
    qp, kpp, vpp, tablep, kvl, qo = _prefill_case(
        gen, 1, Hq, Hkv, D, page, P, Np, C, bf16, kv_len=[kv_len],
        table_ids=P)
    visible = np.minimum(kv_len, q_off + np.arange(C) + 1).sum()
    nbytes = (2 * kv_len * Hkv * D * item + 2 * Hq * C * D * item
              + Np * 4 + 8)
    flops = 4.0 * float(visible) * Hq * D
    kdp, vdp = _dense_kv(kpp, tablep), _dense_kv(vpp, tablep)
    kv_pos = torch.arange(Np * page, device=DEV)
    pmask = ((kv_pos[None] <= (q_off + torch.arange(C, device=DEV))[:, None])
             & (kv_pos[None] < kv_len))[None, None]
    run = (lambda: paged_flash_attention(qp, kpp, vpp, tablep, kvl, qo))
    lib = (lambda: F.scaled_dot_product_attention(
        qp, kdp, vdp, attn_mask=pmask, enable_gqa=True))
    return dict(name="paged_flash_attention", run=run,
                plain=lambda: ref.paged_flash_attention_ref(
                    qp, kpp, vpp, tablep, kvl, qo),
                lib=lib, warm=run, warm_lib=lib, nbytes=nbytes,
                flops=flops, key="_mma")


def _qwen3_rows(errs, gen, F):
    """The paged pair at Qwen3-Coder's attention (Hq 32, Hkv 4, D 128:
    G 8), the shapes of the MoE serve: fused decode over 8 lanes at
    1,090-1,377 (cold L2) and a C 256 pack. Returns {name: timings}."""
    rows, _ = _decode_rows(gen, F, Hkv=4, D=128,
                           names=("paged_attention_fused",), long_lane=False)
    rows.append(_prefill_row(gen, F, Hkv=4, D=128))
    out = {}
    for row in rows:
        name = row["name"]
        errs.check(name, "sdpa_bf16", row["warm"](), row["warm_lib"](),
                   BF16_TOL, "Qwen3 shapes vs library")
        bound, by = _bound(row["nbytes"], row["flops"], BF16_FLOPS)
        k_ms, p_ms = time_ms(row["run"]), time_ms(row["plain"])
        l_ms = time_ms(row["lib"])
        d_ms, ld_ms = device_ms(row["run"], row["key"]), \
            device_ms(row["lib"], "")
        out[name] = dict(shape="Hq 32, Hkv 4, D 128", ms=k_ms, device_ms=d_ms,
                         plain_ms=p_ms, library_ms=l_ms,
                         library_device_ms=ld_ms, bound_ms=bound,
                         bound_by=by)
        log(f"[timing] {name:22s} Qwen3 (G 8, D 128): kernel {k_ms:.4f} ms "
            f"(device {d_ms:.4f})  plain {p_ms:.4f} ms  sdpa {l_ms:.4f} ms "
            f"(device {ld_ms:.4f})  bound {bound:.4f} ms ({by}: "
            f"{row['nbytes'] / 1e6:.2f} MB, {row['flops'] / 1e9:.3f} GFLOP)"
            f"  bound/kernel device {bound / d_ms:.3f}")
    return out


def phase_timing(errs: Errors, launches):
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(11)
    rows, long_lane = _decode_rows(gen, F)
    rows.append(_prefill_row(gen, F))
    # the SDPA yardsticks compute the same function
    for row in rows:
        errs.check(row["name"], "sdpa_bf16", row["warm"](), row["warm_lib"](),
                   BF16_TOL, "vs library")
    errs.check("paged_attention_fused", "sdpa_bf16", long_lane["check"][0](),
               long_lane["check"][1](), BF16_TOL, "16,384-token lane vs "
               "library")
    out = []
    for row in rows:
        name, run, nbytes, flops = row["name"], row["run"], row["nbytes"], \
            row["flops"]
        bound, by = _bound(nbytes, flops, BF16_FLOPS)
        k_ms, p_ms = time_ms(run), time_ms(row["plain"])
        l_ms = time_ms(row["lib"])
        # device times: the launch is shorter than the wrapper's host cost
        d_ms, ld_ms = device_ms(run, row["key"]), device_ms(row["lib"], "")
        out.append({
            "name": name, "route": "cuda", "source": KERNELS[name]["source"],
            "replaces": KERNELS[name]["replaces"],
            "launches": launches[name],
            "max_abs_err": max(v for (n, dt), v in errs.max.items()
                               if n == name and dt != "sdpa_bf16"),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": l_ms, "device_ms": d_ms,
            "library_device_ms": ld_ms})
        cold = "cold L2, " if row["warm"] is not run else ""
        log(f"[timing] {name:22s} {cold}kernel {k_ms:.4f} ms (device "
            f"{d_ms:.4f})  plain {p_ms:.4f} ms  sdpa {l_ms:.4f} ms (device "
            f"{ld_ms:.4f})  bound {bound:.4f} ms ({by}: {nbytes / 1e6:.2f} "
            f"MB, {flops / 1e9:.3f} GFLOP)  bound/kernel {bound / k_ms:.3f} "
            f"(device {bound / d_ms:.3f})")
        if cold:
            w_ms = time_ms(row["warm"])
            wd_ms = device_ms(row["warm"], row["key"])
            wl_ms = device_ms(row["warm_lib"], "")
            out[-1]["warm_l2"] = dict(ms=w_ms, device_ms=wd_ms,
                                      library_device_ms=wl_ms)
            log(f"[timing] {name:22s} warm L2 (one table): kernel {w_ms:.4f} "
                f"ms (device {wd_ms:.4f}), sdpa device {wl_ms:.4f} ms")
        log(f"[timing] {name:22s} earlier {EARLIER_MS[name]:.4f} ms (before "
            "the redesign; from PERF.md, not this run)")
    bound, by = _bound(long_lane["nbytes"], long_lane["flops"], BF16_FLOPS)
    k_ms, l_ms = time_ms(long_lane["run"]), time_ms(long_lane["lib"])
    d_ms = device_ms(long_lane["run"], "paged_decode")
    ld_ms = device_ms(long_lane["lib"], "")
    out[0]["long_lane"] = dict(tokens=16384, ms=k_ms, device_ms=d_ms,
                               library_ms=l_ms, library_device_ms=ld_ms,
                               bound_ms=bound, bound_by=by)
    log(f"[timing] paged_attention_fused one lane of 16,384 tokens (maxp "
        f"512), cold L2: kernel {k_ms:.4f} ms (device {d_ms:.4f})  sdpa "
        f"{l_ms:.4f} ms (device {ld_ms:.4f})  bound {bound:.4f} ms ({by}: "
        f"{long_lane['nbytes'] / 1e6:.2f} MB)  bound/kernel device "
        f"{bound / d_ms:.3f}")
    for name, sub in _qwen3_rows(errs, gen, F).items():
        next(o for o in out if o["name"] == name)["qwen3"] = sub
    return out


def _flex_attention(Sq, Skv, *, q_offset, window, softcap):
    """The one PyTorch call that computes flash_attention's function:
    ``flex_attention`` (compiled, Triton), the softcap as its score_mod
    (applied to the scaled score, before the mask) and the causal and
    window masks as a block mask, so fully masked key blocks are skipped.
    Timed as the library yardstick; the port never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, q_idx, kv_idx):
        q_pos = q_offset + q_idx
        m = kv_idx <= q_pos
        if window:
            m = m & (q_pos - kv_idx < window)
        return m

    block = create_block_mask(mask_mod, None, None, Sq, Skv, device=DEV)
    fn = torch.compile(flex_attention)
    return lambda q, k, v: fn(q, k, v, score_mod=score_mod, block_mask=block,
                              enable_gqa=True)


def phase_flash_timing(errs: Errors):
    """flash_attention at the dense path's chunk (C 512 at q_offset 4,096
    over a 6,144-token slot, Hq 32, Hkv 16, D 128, bf16, the model-layout
    views), for a local (window 4,096) and a global layer, softcap 50.
    The library yardstick is ``flex_attention`` with the same softcap and
    masks, on contiguous copies of the same inputs made beforehand; it is
    held to the plain version at the bf16 tolerance. SDPA (boolean mask),
    which has no softcap, is a side figure against the kernel run without
    softcap. Returns the kernels-JSON row (launches filled in by the
    caller); ms, plain_ms, bound_ms and library_ms are the mean over the
    two layer kinds, which alternate on the path."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(13)
    c = GEMMA2_CHUNK
    Hq, Hkv, Sq, Skv, D, item = c["Hq"], c["Hkv"], c["Sq"], c["Skv"], \
        c["D"], 2
    q, k, v = _flash_inputs(gen, *c.values(), torch.bfloat16,
                            model_layout=True)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = GEMMA2_OFFSET + torch.arange(Sq, device=DEV)
    kv_pos = torch.arange(Skv, device=DEV)
    kinds = {}
    for kind, window in (("local", GEMMA2_WINDOW), ("global", None)):
        kw = dict(q_offset=GEMMA2_OFFSET, window=window)
        mask = kv_pos[None] <= q_pos[:, None]
        if window:
            mask &= q_pos[:, None] - kv_pos[None] < window
        pairs = float(mask.sum().item())
        # keys any row sees, read once; q read once, o written once
        kv_lo = max(0, GEMMA2_OFFSET - window + 1) if window else 0
        kv_hi = min(Skv, GEMMA2_OFFSET + Sq)
        nbytes = 2.0 * (kv_hi - kv_lo) * Hkv * D * item + 2.0 * Hq * Sq * D \
            * item
        flops = 4.0 * pairs * Hq * D
        bound, by = _bound(nbytes, flops, BF16_FLOPS)
        flex = _flex_attention(Sq, Skv, softcap=GEMMA2_SOFTCAP, **kw)

        def run(kw=kw):
            return flash_attention(q, k, v, softcap=GEMMA2_SOFTCAP, **kw)

        def plain(kw=kw):
            return ref.flash_attention_ref(q, k, v, softcap=GEMMA2_SOFTCAP,
                                           **kw)

        def lib(flex=flex):
            return flex(qc, kc, vc)

        def nocap(kw=kw):
            return flash_attention(q, k, v, **kw)

        def sdpa(mask=mask):
            return F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=mask[None, None], enable_gqa=True)

        want = plain()
        errs.check("flex_attention", "bf16", lib(), want,
                   _attn_tol(torch.bfloat16, want), f"{kind} vs plain")
        errs.check("flash_attention", "sdpa_bf16", nocap(), sdpa(),
                   FLASH_BF16_TOL, f"{kind} vs library")
        k_ms, p_ms, l_ms = time_ms(run), time_ms(plain), time_ms(lib)
        n_ms, s_ms = time_ms(nocap), time_ms(sdpa)
        d_ms, ld_ms = device_ms(run, "_mma"), device_ms(lib, "")
        kinds[kind] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                           bound_by=by, library_ms=l_ms, device_ms=d_ms,
                           library_device_ms=ld_ms,
                           ms_without_softcap=n_ms,
                           sdpa_without_softcap_ms=s_ms)
        log(f"[timing] flash_attention {kind:6s} kernel {k_ms:.4f} ms  "
            f"plain {p_ms:.4f} ms  flex {l_ms:.4f} ms  bound {bound:.4f} ms "
            f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)  "
            f"bound/kernel {bound / k_ms:.3f}, flex/kernel {l_ms / k_ms:.3f}; "
            f"device time: kernel {d_ms:.4f} ms, flex {ld_ms:.4f} ms; without "
            f"softcap: kernel {n_ms:.4f} ms, sdpa {s_ms:.4f} ms")
        log(f"[timing] flash_attention {kind:6s} earlier "
            f"{EARLIER_MS['flash_attention'][kind]:.4f} ms (CUDA cores; from "
            "PERF.md, not this run)")
    mean = (lambda key: (kinds["local"][key] + kinds["global"][key]) / 2)
    log(f"[timing] flex_attention vs plain max_abs_err "
        f"{errs.max[('flex_attention', 'bf16')]:.3e}")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": KERNELS["flash_attention"]["source"],
        "replaces": KERNELS["flash_attention"]["replaces"],
        "launches": None,
        "max_abs_err": max(v for (n, dt), v in errs.max.items()
                           if n == "flash_attention" and dt != "sdpa_bf16"),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": kinds["global"]["bound_by"],
        "library_ms": mean("library_ms"), "per_layer_kind": kinds,
        "launches_per_chunk": get_config("gemma2-27b").n_layers}


# flash_attention at the shapes the zamba2 and whisper paths give it:
# label -> (B, H, Sq, Skv, D), causal (Hq = Hkv: MHA)
SSM_FLASH_TIMING = {
    "whisper cross-attention": ((8, 6, 448, 1500, 64), False),
    "zamba2 shared block": ((8, 32, 1024, 1024, 64), True)}


def phase_flash_ssm_timing(errs: Errors) -> None:
    """flash_attention in bf16 at whisper's cross-attention (the decoder's
    448 rows over 1,500 encoder frames, non-causal) and at zamba2's shared
    block in the prefill (T 1,024, causal, G 1), on model-layout views:
    CUDA-event and profiler device times against the plain version, SDPA
    on contiguous copies of the same inputs (held to the plain version
    too) and the bound. Logged only: the kernels JSON's flash row stays
    the dense path's chunk."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(17)
    for label, ((B, H, Sq, Skv, D), causal) in SSM_FLASH_TIMING.items():
        q, k, v = _flash_inputs(gen, B, H, H, Sq, Skv, D, torch.bfloat16,
                                model_layout=True)
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        # keys each row sees: all of them, or (causal, Sq == Skv) 1..Sq
        pairs = Sq * (Sq + 1) / 2 if causal else Sq * Skv
        flops = 4.0 * B * H * pairs * D
        nbytes = 2.0 * B * H * (2 * Sq + 2 * Skv) * D   # q, o; k, v
        bound, by = _bound(nbytes, flops, BF16_FLOPS)

        def run(q=q, k=k, v=v, causal=causal):
            return flash_attention(q, k, v, causal=causal)

        def plain(q=q, k=k, v=v, causal=causal):
            return ref.flash_attention_ref(q, k, v, causal=causal)

        def sdpa(qc=qc, kc=kc, vc=vc, causal=causal):
            return F.scaled_dot_product_attention(qc, kc, vc,
                                                  is_causal=causal)

        want = plain()
        tol = _attn_tol(torch.bfloat16, want)
        err = errs.check("flash_attention", torch.bfloat16, run(), want, tol,
                         f"{label} timing inputs")
        s_err = errs.check("sdpa", "bf16", sdpa(), want, tol, label)
        k_ms, p_ms, s_ms = time_ms(run), time_ms(plain), time_ms(sdpa)
        d_ms, sd_ms = device_ms(run, "_mma"), device_ms(sdpa, "")
        log(f"[timing] flash_attention {label} (B={B} H={H} Sq={Sq} "
            f"Skv={Skv} D={D} causal={causal}, bf16): kernel {k_ms:.4f} ms "
            f"(device {d_ms:.4f})  plain {p_ms:.4f} ms  sdpa {s_ms:.4f} ms "
            f"(device {sd_ms:.4f})  bound {bound:.4f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)  bound/kernel "
            f"device {bound / d_ms:.3f}, sdpa/kernel device "
            f"{sd_ms / d_ms:.3f}; max abs err vs plain: kernel {err:.3e}, "
            f"sdpa {s_err:.3e} (tol {tol:.3e})")


def _wkv_bound(B, T, H, K, item):
    """r/k/v read once in the model type, w read and o written in f32, u
    read, the state read and written once in f32; about 5*K^2 flops per
    (b, h, t), f32 work priced at the TF32 tensor-core peak (a chunked form
    runs it as matrix products)."""
    n = B * T * H * K
    nbytes = 3.0 * n * item + 2.0 * n * 4 + H * K * 4 + 2.0 * B * H * K * K * 4
    flops = 5.0 * B * T * H * K * K
    return nbytes, flops


def phase_wkv_timing(errs: Errors):
    """wkv6 at the main path's prefill (B 8, T 1,024, H 32, K 64, bf16 r/k/v)
    and decode (B 8, T 1) shapes with the model's decay distribution. The
    kernel's ms is its device time from the profiler; ``ms_events`` is the
    CUDA-event time of back-to-back wrapper calls, which at the decode
    shape is the host's enqueue rate. No PyTorch call computes WKV6, so
    there is no library time. The row's ms, plain_ms and bound_ms are the
    prefill's; ``per_shape`` holds both."""
    gen = torch.Generator(device=DEV).manual_seed(19)
    shapes = {}
    for label, shape in (("prefill", WKV_PREFILL), ("decode", WKV_DECODE)):
        args = _wkv_inputs(gen, *shape.values(), torch.bfloat16,
                           model_like=True)
        nbytes, flops = _wkv_bound(*shape.values(), 2)
        bound, by = _bound(nbytes, flops, TF32_FLOPS)
        k_ms = device_ms(lambda: wkv6(*args), "wkv6_")
        e_ms = time_ms(lambda: wkv6(*args))
        p_ms = time_ms(lambda: ref.wkv6_ref(*args),
                       iters=5 if shape["T"] > 1 else 50)
        shapes[label] = dict(ms=k_ms, ms_events=e_ms, plain_ms=p_ms,
                             bound_ms=bound, bound_by=by, shape=shape)
        log(f"[timing] wkv6 {label:7s} {shape}: kernel {k_ms:.4f} ms "
            f"(events {e_ms:.4f} ms)  plain {p_ms:.4f} ms  bound "
            f"{bound:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP; f32 CUDA cores "
            f"{flops / F32_FLOPS * 1e3:.4f} ms)  bound/kernel "
            f"{bound / k_ms:.3f}")
    log(f"[timing] wkv6 prefill earlier {EARLIER_MS['wkv6']:.4f} ms (device; "
        "before the redesign; from PERF.md, not this run)")
    pre = shapes["prefill"]
    return {
        "name": "wkv6", "route": "cuda", "source": KERNELS["wkv6"]["source"],
        "replaces": KERNELS["wkv6"]["replaces"], "launches": None,
        "max_abs_err": max(v for (n, dt), v in errs.max.items()
                           if n == "wkv6"),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": None, "per_shape": shapes}


# ---------------------------------------------------------------------------
# 7. profile one full-width mixed iteration
# ---------------------------------------------------------------------------

def _mixed_args(P: int, page: int = 32, Np: int = 64, C: int = 256,
                B: int = 8):
    """lm_mixed_paged's arguments for one full-width mixed iteration over
    a pool of ``P`` pages: a pack of C at q_offset 1,024 on pages 512-575
    plus B decode lanes at 1,090-1,377 on pages 0-511."""
    lens = np.array(MAIN_LENS[:B], np.int32)
    d_tables = np.arange(B * Np, dtype=np.int32).reshape(B, Np) % P
    i32 = (lambda a: torch.as_tensor(np.asarray(a, np.int32), device=DEV))
    return (i32(np.zeros((1, 1, C))), i32((1024 + np.arange(C))[None, None]),
            i32(np.arange(Np)[None] + 512), i32(512 + (1024 + np.arange(C))
                                                [None] // page),
            i32((1024 + np.arange(C))[None] % page), i32([1024 + C]),
            i32([C - 1]), i32(np.zeros(B)), i32(lens - 1), i32(d_tables),
            i32(lens), i32(d_tables[np.arange(B), (lens - 1) // page]),
            i32((lens - 1) % page))


def _no_host_sync(fn, what: str) -> None:
    """Runs ``fn`` once with CUDA's sync debug mode set to raise: a model
    call that reads a device value back to the host (``.item()``, a
    data-dependent shape, indexing with a 0-d device tensor) fails here.
    ROADMAP item 1.2's CUDA-graph capture relies on there being none. The
    mode is a prototype and may miss some synchronising operations."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise AssertionError(f"{what}: a host sync inside the call: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[profile] {what}: no host sync (CUDA sync debug mode)")


def phase_profile():
    cfg = get_config("llama3.2-1b")
    params = tf.init_lm(cfg, torch.Generator(device=DEV).manual_seed(1),
                        torch.bfloat16, DEV)
    page, P, C, B = 32, 1024, 256, 8
    cache = tf.PagedKVCache.zeros(cfg, P + 1, page, torch.bfloat16, DEV)
    args = _mixed_args(P)
    _no_host_sync(lambda: tf.lm_mixed_paged(cfg, params, cache, *args),
                  "llama3.2-1b lm_mixed_paged")
    _, device, mine, _ = _profile(
        f"lm_mixed_paged full width, 1 pack C={C} + {B} decode lanes",
        lambda: tf.lm_mixed_paged(cfg, params, cache, *args),
        focus="paged_decode")
    log(f"[profile]   paged_attention_fused: {mine / cfg.n_layers:.4f} ms "
        f"device time per call ({cfg.n_layers} calls, split + combine), "
        f"{mine:.3f} of the iteration's {device:.3f} ms")


MOE_PARTS = ("_route", "_dispatch", "_expert_ffn", "_combine")


@contextlib.contextmanager
def _moe_labels():
    """Each MoE step of ``layers.moe_ffn`` inside a profiler range named
    ``moe:<step>``, so that the trace sums its device time; restored on
    exit. Only the traced calls run with it."""
    from torch.profiler import record_function
    from repro_torch.models import layers
    saved = {n: getattr(layers, n) for n in MOE_PARTS}

    def labelled(n, f):
        def g(*a, **k):
            with record_function(f"moe:{n}"):
                return f(*a, **k)
        return g
    for n, f in saved.items():
        setattr(layers, n, labelled(n, f))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(layers, n, f)


def phase_profile_moe(backend) -> None:
    """One full-width qwen3-coder-30b-a3b mixed iteration (a pack of C 256
    at q_offset 1,024 plus 8 decode lanes at 1,090-1,377) on the serve's
    weights and pool: wall against device time, idle share, and device
    time by MoE step (route, dispatch, the expert products, combine) and
    by paged kernel. Every forward runs every expert's products over its
    capacity buffer, whatever the routing, as the JAX package does: the
    iteration reads all 128 experts' weights twice."""
    cfg, params, cache = backend.cfg, backend.params, backend._impl.cache
    args = _mixed_args(cache.n_pages - 1)
    m = cfg.moe
    expert_bytes = 3 * m.num_experts * cfg.d_model * m.d_ff_expert * 2
    floor = 2 * cfg.n_layers * expert_bytes / HBM_BYTES_PER_S * 1e3
    _no_host_sync(lambda: tf.lm_mixed_paged(cfg, params, cache, *args),
                  "qwen3-coder lm_mixed_paged")
    wall, device, _, by_label = _profile(
        f"qwen3-coder lm_mixed_paged full width, 1 pack C=256 + 8 decode "
        f"lanes ({cfg.n_layers} layers, both forwards over all "
        f"{m.num_experts} experts)",
        lambda: tf.lm_mixed_paged(cfg, params, cache, *args),
        labels=[f"moe:{n}" for n in MOE_PARTS], traced_ctx=_moe_labels,
        kernels={"paged_decode": "paged_attention_fused",
                 "_mma": "paged_flash_attention"})
    parts = "  ".join(f"{k} {v:.3f}" for k, v in by_label.items())
    log(f"[profile-moe] device ms/iter by part: {parts}; the rest "
        f"{device - sum(by_label.values()):.3f} (projections, lm_head, "
        f"norms, copies)")
    log(f"[profile-moe] the expert weights read twice (prefill pack and "
        f"decode forwards): {2 * cfg.n_layers * expert_bytes / 1e9:.1f} GB,"
        f" {floor:.2f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s (reckoned);"
        f" device {device:.3f} ms, wall {wall:.3f} ms")
    _rank_scan_layouts(m, T=256)


def _rank_scan_layouts(m, T: int) -> None:
    """Why ``_dispatch`` holds its one-hot expert-major: the capacity
    ranks of one C-256 pack (T*K entries over E experts) scanned along
    the rows of (E, T*K), as the port does, against down the columns of
    (T*K, E), the layout of JAX's scan; device time per call, the same
    ranks."""
    gen = torch.Generator(device=DEV).manual_seed(21)
    E, N = m.num_experts, T * m.top_k
    flat = torch.randint(0, E, (N,), generator=gen, device=DEV)

    def token_major():
        oh = torch.zeros((N, E), dtype=torch.int32, device=DEV)
        oh.scatter_(1, flat[:, None], 1)
        return torch.cumsum(oh, 0, dtype=torch.int32).gather(
            1, flat[:, None])[:, 0]

    def expert_major():
        oh = torch.zeros((E, N), dtype=torch.int32, device=DEV)
        oh.scatter_(0, flat[None], 1)
        return torch.cumsum(oh, 1, dtype=torch.int32).gather(0, flat[None])[0]
    if not torch.equal(token_major(), expert_major()):
        raise AssertionError("rank scan layouts disagree")
    ms = {name: device_ms(fn, "") for name, fn in
          (("expert-major", expert_major), ("token-major", token_major))}
    log(f"[profile-moe] dispatch rank scan of {N} entries over {E} experts:"
        f" expert-major (the port) {ms['expert-major']:.4f} ms, token-major "
        f"{ms['token-major']:.4f} ms of device time a call")


def _profile(label: str, fn, traced: int = 3, focus: str = "", labels=(),
             traced_ctx=contextlib.nullcontext, kernels=None, timed: int = 5,
             warm: int = 2):
    """Wall time per call with the profiler off (``timed`` calls after
    ``warm`` warm-up calls) and device time by kernel over ``traced``
    profiled calls (run
    inside ``traced_ctx()``); logs the idle share, the top kernels and the
    device-time share of the kernels whose name holds ``focus``. Returns
    (wall_ms, device_ms, focus_ms, parts), all per call; ``parts`` maps
    each of ``labels`` (profiler ranges) to the device time of the kernels
    launched inside it, and each value of ``kernels`` ({name substring:
    part}) to the device time of the kernels whose name holds the key."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(timed):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / timed     # profiler off
    with traced_ctx(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    # kernels only: a range's device-side copy would count its span again
    evs = [e for e in avg
           if getattr(e, "device_time_total", 0) > 0 and e.key not in labels
           and "CUDA" in str(getattr(e, "device_type", ""))]
    total = sum(e.device_time_total for e in evs) / (traced * 1e3)
    launches = sum(e.count for e in evs) / traced
    log(f"[profile] {label}: wall {wall_ms:.3f} ms/iter (profiler off), "
        f"device {total:.3f} ms/iter, idle share "
        f"{max(0.0, 1 - total / wall_ms):.3f}, {launches:.0f} kernels/iter")
    for e in sorted(evs, key=lambda e: -e.device_time_total)[:8]:
        log(f"[profile]   {e.device_time_total / (traced * 1e3):9.3f} "
            f"ms/iter x{e.count // traced:4d}  {e.key[:90]}")
    mine = 0.0
    if not evs:
        log("[profile] no device time in the trace: not measured")
    elif focus:
        mine = sum(e.device_time_total for e in evs if focus in e.key) / (
            traced * 1e3)
        log(f"[profile]   {focus}: {mine:.3f} ms/iter, share of device time "
            f"{mine / total:.3f}, of wall time {mine / wall_ms:.3f}")
    by_label = {}
    for name in labels:
        # the range's CPU-side entry sums the device time of the kernels
        # launched inside it (its device-side entry is its span, gaps
        # included)
        times = [e.device_time_total for e in avg if e.key == name
                 and "CUDA" not in str(getattr(e, "device_type", ""))]
        by_label[name] = max(times, default=0.0) / (traced * 1e3)
        if not by_label[name]:
            log(f"[profile]   {name}: no device time in the trace, not "
                "measured")
    for key, name in (kernels or {}).items():
        by_label[name] = sum(e.device_time_total for e in evs
                             if key in e.key) / (traced * 1e3)
    return wall_ms, total, mine, by_label


def phase_profile_rwkv(params) -> None:
    """One full-width rwkv6 prefill (B 8, T 1,024) and one decode step of
    the 8 sessions, on the serve's weights."""
    cfg = get_config("rwkv6-1.6b")
    B, T = RWKV_SERVE["sessions"], RWKV_SERVE["prompt"]
    toks = torch.zeros((B, T), dtype=torch.int32, device=DEV)
    _profile(f"rwkv6 prefill B={B} T={T} ({cfg.n_layers} wkv6 launches)",
             lambda: model_zoo.prefill(cfg, params, {"tokens": toks}),
             focus="wkv6")
    _, state = model_zoo.prefill(cfg, params, {"tokens": toks})
    tok = torch.zeros((B,), dtype=torch.int32, device=DEV)
    _profile(f"rwkv6 decode step B={B}",
             lambda: model_zoo.decode(cfg, params, state, tok, tok),
             focus="wkv6")


def phase_profile_dense(backend) -> None:
    """One full-width dense prefill chunk (C 512 at q_offset 4,096, slot 0)
    and one dense decode step over the 4 slots, on the serve's weights and
    cache; then the share of the decode step that its plain attention
    (``layers.attention`` over every slot's 6,144 positions) takes."""
    from repro_torch.models import layers
    cfg, params, cache = backend.cfg, backend.params, backend._impl.cache
    C, q0 = GEMMA2_CHUNK["Sq"], GEMMA2_OFFSET
    toks = torch.zeros((1, C), dtype=torch.int32, device=DEV)
    slot0 = tf.KVCache(cache.k[:, :1], cache.v[:, :1])
    _profile(f"dense lm_step prefill chunk C={C} at q_offset {q0} "
             f"({cfg.n_layers} flash_attention launches)",
             lambda: tf.lm_step(cfg, params, slot0, toks, q_offset=q0))
    R, Smax = cache.k.shape[1], cache.k.shape[2]
    d_pos = torch.tensor([4700, 4650, 1100, 1050][:R], dtype=torch.int32,
                         device=DEV)
    d_toks = torch.zeros((R,), dtype=torch.int32, device=DEV)
    wall, _, _, _ = _profile(f"dense lm_decode step over {R} slots of "
                             f"{Smax}",
                          lambda: tf.lm_decode(cfg, params, cache, d_toks,
                                               d_pos))
    # the decode step's plain attention alone, at its shapes, per kind
    gen = torch.Generator(device=DEV).manual_seed(17)
    q = _randn(gen, (R, 1, cfg.n_heads, cfg.head_dim_), torch.bfloat16)
    kv_pos = torch.arange(Smax, dtype=torch.int32, device=DEV).expand(R, Smax)
    q_pos = d_pos[:, None]
    valid = kv_pos <= q_pos
    per_kind = {}
    for is_local in (True, False):
        per_kind[is_local] = time_ms(lambda: layers.attention(
            q, cache.k[0], cache.v[0], q_pos, kv_pos, kv_valid=valid,
            window=cfg.sliding_window, is_local=is_local,
            softcap=cfg.attn_logit_softcap), iters=20)
    n_local = sum(tf.layer_kind_flags(cfg))
    attn_ms = n_local * per_kind[True] + \
        (cfg.n_layers - n_local) * per_kind[False]
    log(f"[profile] dense decode plain attention: local {per_kind[True]:.4f}"
        f" ms, global {per_kind[False]:.4f} ms per layer; x{cfg.n_layers} "
        f"layers = {attn_ms:.3f} ms of a {wall:.3f} ms step "
        f"(share {attn_ms / wall:.3f})")


# ---------------------------------------------------------------------------
# 12. train: gradients through the kernels, the trainer at full width
# ---------------------------------------------------------------------------

TRAIN_PARITY = (("llama3.2-1b", 64), ("gemma2-27b", 128),
                ("granite-moe-3b-a800m", 64), ("rwkv6-1.6b", 64),
                ("zamba2-1.2b", 64), ("whisper-tiny", 64))
# card vs CPU, x each leaf's largest |CPU gradient|: about 9x the worst
# leaf read on the H100 (PERF.md: 2.14e-6 on the LM families, 2.27e-5 on
# rwkv6, whose random-init backward grows the gradient ~200x)
GRAD_REL_TOL = {"rwkv6": 2e-4}
GRAD_TOL = 2e-5
# the leaves that reach the loss only through the kernel's output
KERNEL_LEAVES = {"lm": ("layers.attn.wq", "layers.attn.wk", "layers.attn.wv"),
                 "rwkv6": ("layers.wr", "layers.wk", "layers.wv",
                           "layers.decay_A", "layers.decay_B",
                           "layers.w_base", "layers.u"),
                 "zamba2": ("shared.attn.wq", "shared.attn.wk",
                            "shared.attn.wv", "mamba_layers.w_x",
                            "mamba_layers.w_B", "mamba_layers.w_C",
                            "mamba_layers.w_dt"),
                 "whisper": tuple(f"{part}.{w}" for part in (
                     "enc_layers.attn", "dec_layers.self_attn",
                     "dec_layers.cross_attn") for w in ("wq", "wk", "wv"))}
TRAIN_FULL = dict(arch="llama3.2-1b", reduced=False, steps=10, seq_len=1024,
                  batch=8)
TRAIN_RWKV = dict(arch="rwkv6-1.6b", reduced=False, steps=3, seq_len=512,
                  batch=4)
TRAIN_BF16 = dict(arch="llama3.2-1b", reduced=False, steps=1, seq_len=1024,
                  batch=8)
TRAIN_ZAMBA = dict(arch="zamba2-1.2b", reduced=False, steps=3, seq_len=512,
                   batch=4)
TRAIN_WHISPER = dict(arch="whisper-tiny", reduced=False, steps=3,
                     seq_len=448, batch=8)
TRAIN_RESTART = dict(arch="llama3.2-1b", steps=8, seq_len=64, batch=4)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _named_leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _launches(name):
    return KERNELS[name]["fn"].launches


def _train_parity(arch: str, S: int) -> dict:
    """One train loss and its gradient, ``.reduced()`` in float32 with
    remat (and chunked CE on the LM families), on the same weights and
    batch: card (kernels forward, their Functions' backward) against the
    CPU (plain versions). Loss within 1e-5 relative; every leaf within
    GRAD_TOL of its largest |CPU gradient| (GRAD_REL_TOL for rwkv6); the
    leaves that reach the loss only through the kernel nonzero on the card
    and matching; the kernel launched during the step."""
    cfg = get_config(arch).reduced()
    family = "lm" if cfg.family in ("dense", "moe") else cfg.family
    kernel = "wkv6" if family == "rwkv6" else "flash_attention"
    params = model_zoo.init(cfg, 0, torch.float32, device="cpu")
    dparams = _to_device(params)
    rng = np.random.default_rng(11)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, S))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    if family == "whisper":
        batch["frames"] = torch.from_numpy((rng.standard_normal(
            (2, 16, cfg.d_model)) * 0.1).astype(np.float32))
    kw = dict(remat=True, chunked_ce=family == "lm")
    lc, gc_ = train_steps.loss_and_grads(cfg, params, batch, **kw)
    before = _launches(kernel)
    lg, gg = train_steps.loss_and_grads(
        cfg, dparams, {k: v.to(DEV) for k, v in batch.items()}, **kw)
    launched = _launches(kernel) - before
    tol = GRAD_REL_TOL.get(cfg.family, GRAD_TOL)
    if not abs(lg.item() - lc.item()) <= 1e-5 * abs(lc.item()):
        raise AssertionError(f"train {arch}: loss {lg.item()} on the card, "
                             f"{lc.item()} on the cpu")
    worst, n = 0.0, 0
    grads_dev = dict(_named_leaves(gg))
    for name, want in _named_leaves(gc_):
        got = grads_dev[name].float().cpu()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        n += 1
        if not err <= tol * scale:
            raise AssertionError(f"train {arch} grad {name}: max abs err "
                                 f"{err} > {tol} x {scale}")
        if name in KERNEL_LEAVES[family] and not got.abs().max() > 0:
            raise AssertionError(f"train {arch}: {name}'s gradient is zero "
                                 f"on the card: the {kernel} output was "
                                 "detached")
    if launched < _step_launches(cfg):
        raise AssertionError(f"train {arch}: {kernel} launched {launched} "
                             f"times in the step")
    log(f"[train] {arch} reduced f32 S={S}: loss card {lg.item():.6f} cpu "
        f"{lc.item():.6f}; {n} gradient leaves, worst err {worst:.2e} of the "
        f"leaf's largest |cpu gradient| (tol {tol}); "
        f"{', '.join(KERNEL_LEAVES[family])} nonzero; {kernel} launched "
        f"{launched} times")
    return {arch: launched}


def _step_launches(cfg) -> int:
    """The least kernel launches of one train step with remat: the forward
    and the recompute of each checkpointed layer, so every layer twice on
    the LM families and rwkv6; zamba2's shared block once per application
    (its Mamba layers are checkpointed, the block is not); whisper's
    encoder layers once and its decoder layers' two attentions twice."""
    if cfg.family == "zamba2":
        return len(zamba2.shared_positions(cfg))
    if cfg.family == "whisper":
        return cfg.n_enc_layers + 4 * cfg.n_layers
    return 2 * cfg.n_layers


def _guard_check() -> None:
    """On a CUDA tensor that requires grad, the flash wrapper returns a
    result attached to autograd and a serving-only wrapper raises."""
    gen = torch.Generator(device=DEV).manual_seed(19)
    q = _randn(gen, (1, 4, 64, 64), torch.float32).requires_grad_(True)
    k, v = (_randn(gen, (1, 2, 64, 64), torch.float32) for _ in range(2))
    if flash_attention(q, k, v).grad_fn is None:
        raise AssertionError("flash_attention returned a detached result")
    qd = _randn(gen, (2, 4, 64), torch.float32).requires_grad_(True)
    pages = _randn(gen, (4, 16, 2, 64), torch.float32)
    table = torch.zeros((2, 2), dtype=torch.int32, device=DEV)
    lens = torch.full((2,), 8, dtype=torch.int32, device=DEV)
    try:
        paged_attention(qd, pages, pages, table, lens)
    except RuntimeError as e:
        if "detached" not in str(e):
            raise
    else:
        raise AssertionError("paged_attention took a grad-requiring input")
    log("[train] grad guard: flash_attention attaches to autograd; "
        "paged_attention refuses a grad-requiring input")


TRAIN_FUNCTIONS = {"flash_attention": _FlashAttention, "wkv6": _WKV6}


@contextlib.contextmanager
def _first_calls():
    """Detached copies of the arguments of each training kernel's first
    call through its autograd Function while the block runs (layer 0 of
    the first batch), by kernel name."""
    first = {}

    def spy(name, orig):
        def apply(*args):
            if name not in first:
                first[name] = tuple(a.detach().clone() if torch.is_tensor(a)
                                    else a for a in args)
            return orig(*args)
        return apply
    for name, fn in TRAIN_FUNCTIONS.items():
        fn.apply = spy(name, fn.apply)
    try:
        yield first
    finally:
        for fn in TRAIN_FUNCTIONS.values():
            del fn.apply                 # back to Function.apply


def _hold_train_kernel(label: str, name: str, args) -> None:
    """A training kernel against its plain version at the inputs a run
    gave it: the wrapper's output (kernel forward) against
    ``flash_attention_ref`` / ``wkv6_chunked``, and its Function's input
    gradients for a random cotangent against autograd's gradient of the
    plain version. Tolerance: ``_attn_tol`` for flash (f32 2e-5 absolute;
    bf16 2e-2 of the tensor's scale, capped); for wkv6 1e-5 of each
    tensor's largest magnitude (WKV_REL_TOL, the main-path check's own:
    outputs and gradients reach the hundreds). Logs every error beside its
    tolerance; raises after logging if any is past it."""
    if name == "flash_attention":
        tensors, (causal, window, softcap, q_offset) = args[:3], args[3:]
        opts = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=q_offset)
        kernel = functools.partial(flash_attention, **opts)
        plain = functools.partial(ref.flash_attention_ref, **opts)
        parts = ("o", "dq", "dk", "dv")
    else:
        tensors, chunk = args[:6], args[6]
        kernel = functools.partial(wkv6, chunk=chunk)
        plain = functools.partial(ref.wkv6_chunked, chunk=chunk)
        parts = ("o", "state", "dr", "dk", "dv", "dw", "du", "dstate")
    a = [t.clone().requires_grad_(True) for t in tensors]
    b = [t.clone().requires_grad_(True) for t in tensors]
    before = _launches(name)
    got, want = kernel(*a), plain(*b)
    if _launches(name) != before + 1:
        raise AssertionError(f"train {label}: the {name} wrapper did not "
                             "launch its kernel once")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    gen = torch.Generator(device=DEV).manual_seed(29)
    cot = [_randn(gen, w.shape, w.dtype) for w in want]
    got_g = torch.autograd.grad(got, a, cot)
    want_g = torch.autograd.grad(want, b, cot)
    dtype = tensors[0].dtype
    shapes = " ".join("x".join(map(str, t.shape)) for t in tensors)
    report, bad = [], []
    for part, g, w in zip(parts, (*got, *got_g), (*want, *want_g)):
        if name == "flash_attention":
            tol = _attn_tol(dtype, w)
        else:
            tol = WKV_REL_TOL * w.float().abs().max().item()
        finite = bool(torch.isfinite(g.float()).all())
        err = (g.float() - w.float()).abs().max().item()
        report.append(f"{part} {err:.3e} (tol {tol:.3e})")
        if not (finite and err <= tol):
            bad.append(part)
    log(f"[train] {label}: {name} {str(dtype)[6:]} at the run's first "
        f"call ({shapes}) vs its plain version, max abs err: "
        + ", ".join(report))
    if bad:
        raise AssertionError(f"train {label}: {name} {bad} past tolerance "
                             "or not finite")


def _train_run(label: str, dtype=torch.float32, remat=True, chunked_ce=True,
               **run):
    """``launch.train.train`` on the card, its per-step lines logged
    (wall to the loss read back, tokens/s, peak memory), then each kernel
    the run launched held against its plain version at the run's first
    call (``_hold_train_kernel``, after the launches are counted); returns
    the losses, the kernel launches and the trained params."""
    counts = {n: _launches(n) for n in ("flash_attention", "wkv6")}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with _first_calls() as first:
        losses, params = train(**run, dtype=dtype, remat=remat,
                               chunked_ce=chunked_ce, log_every=1,
                               device="cuda")
    dt = time.monotonic() - t0
    launched = {n: _launches(n) - c for n, c in counts.items()}
    bad = [x for x in losses if not np.isfinite(x)]
    if bad or not losses:
        raise AssertionError(f"train {label}: losses {losses}")
    log(f"[train] {label}: {len(losses)} steps in {dt:.2f}s (init "
        f"included); losses {[round(x, 4) for x in losses]}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; kernel "
        f"launches {launched}")
    for name, args in first.items():
        _hold_train_kernel(label, name, args)
    if set(first) != {n for n, c in launched.items() if c}:
        raise AssertionError(f"train {label}: kernels {launched} launched, "
                             f"first calls seen {sorted(first)}")
    return losses, launched, params


TRAIN_RANGES = ("plain backward (flash_attention)", "adamw_update")


@contextlib.contextmanager
def _train_ranges():
    """Profiler ranges around the flash Function's plain backward and the
    optimizer update; restored on exit."""
    from torch.profiler import record_function
    from repro_torch.kernels import _grad
    orig_bwd, orig_opt = _grad.plain_backward, train_steps.adamw_update

    def bwd(*a, **k):
        with record_function(TRAIN_RANGES[0]):
            return orig_bwd(*a, **k)

    def opt(*a, **k):
        with record_function(TRAIN_RANGES[1]):
            return orig_opt(*a, **k)
    _grad.plain_backward, train_steps.adamw_update = bwd, opt
    try:
        yield
    finally:
        _grad.plain_backward, train_steps.adamw_update = orig_bwd, orig_opt


def _profile_train(params) -> None:
    """One more full-width llama train step on the trained weights, timed
    with the profiler off, then one traced: device time, idle share, the
    flash kernel, the plain backward's recompute, the optimizer."""
    cfg = get_config(TRAIN_FULL["arch"])
    if TRAIN_FULL["reduced"]:
        cfg = cfg.reduced()
    B, S = TRAIN_FULL["batch"], TRAIN_FULL["seq_len"]
    step = train_steps.build_train_step(cfg, remat=True, chunked_ce=True)
    state = [init_opt(params)]
    gen = torch.Generator(device=DEV).manual_seed(23)
    batch = {k: torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                              device=DEV, dtype=torch.int32)
             for k in ("tokens", "targets")}

    def one():
        _, state[0], m = step(params, state[0], batch)
        m["loss"].item()
    _, total, flash, parts = _profile(
        f"llama3.2-1b full-width f32 train step B={B} S={S} (remat, "
        f"chunked CE)", one, traced=1, timed=1, warm=0, focus="flash",
        labels=TRAIN_RANGES, traced_ctx=_train_ranges)
    log(f"[profile] train step: flash_attention kernel {flash:.3f} ms, "
        + ", ".join(f"{k} {v:.3f} ms ({v / total:.3f} of device time)"
                    for k, v in parts.items()))


def phase_train() -> dict:
    """Gradients through the kernels (card vs CPU on six reduced
    families), the grad guard, then the trainer on the card: full-width
    llama3.2-1b (f32, remat, chunked CE) whose loss must fall, full-width
    rwkv6-1.6b, one full-width bf16 llama step, full-width zamba2-1.2b
    and whisper-tiny (f32, remat, 3 steps each; each kernel of each
    full-width run held against its plain version at the run's first
    call, output and gradients), and a reduced llama run stopped halfway
    and resumed from its checkpoint, loss for loss equal to the
    uninterrupted run."""
    launches = {}
    for arch, S in TRAIN_PARITY:
        launches.update(_train_parity(arch, S))
    _guard_check()
    gc.collect()
    torch.cuda.empty_cache()
    losses, launched, params = _train_run(
        f"llama3.2-1b full width f32 B={TRAIN_FULL['batch']} "
        f"S={TRAIN_FULL['seq_len']}", **TRAIN_FULL)
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not last < first or launched["flash_attention"] <= 0:
        raise AssertionError(f"train llama full width: loss {first} -> "
                             f"{last}, flash launches {launched}")
    log(f"[train] llama full width: mean loss of the first 3 steps "
        f"{first:.4f}, of the last 3 {last:.4f}")
    launches["llama3.2-1b full width"] = launched["flash_attention"]
    _profile_train(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launched = _train_run(f"rwkv6-1.6b full width f32 B="
                          f"{TRAIN_RWKV['batch']} S="
                          f"{TRAIN_RWKV['seq_len']}", chunked_ce=False,
                          **TRAIN_RWKV)[1]
    if launched["wkv6"] <= 0:
        raise AssertionError("train rwkv6: wkv6 never launched")
    launches["rwkv6-1.6b full width"] = launched["wkv6"]
    gc.collect()
    torch.cuda.empty_cache()
    launched = _train_run("llama3.2-1b full width bf16, one step",
                          dtype=torch.bfloat16, **TRAIN_BF16)[1]
    if launched["flash_attention"] <= 0:
        raise AssertionError("train bf16: flash_attention never launched")
    gc.collect()
    torch.cuda.empty_cache()
    for run in (TRAIN_ZAMBA, TRAIN_WHISPER):
        label = (f"{run['arch']} full width f32 B={run['batch']} "
                 f"S={run['seq_len']}")
        launched = _train_run(label, chunked_ce=False, **run)[1]
        if launched["flash_attention"] <= 0:
            raise AssertionError(f"train {label}: flash_attention never "
                                 "launched")
        launches[f"{run['arch']} full width"] = launched["flash_attention"]
        gc.collect()
        torch.cuda.empty_cache()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "train_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    try:
        n = TRAIN_RESTART["steps"]
        run = dict(TRAIN_RESTART, reduced=True, verbose=False, device="cuda")
        full, _ = train(**run)
        part, _ = train(**run, stop_after=n // 2, ckpt_dir=d,
                        ckpt_every=n // 2)
        resumed, _ = train(**run, ckpt_dir=d, resume=True, ckpt_every=100)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if part != full[:n // 2] or resumed != full[n // 2:]:
        raise AssertionError(f"train restart: {full} vs {part} + {resumed}")
    log(f"[train] restart: {n} steps equal {n // 2} + {n // 2} resumed from "
        f"the checkpoint, loss for loss ({full[-1]:.6f} at the end)")
    return launches


def _kernel_name(mangled: str) -> str:
    """``flash_kernel_mma<128, 1>`` from nvcc's mangled name of a kernel
    in an anonymous namespace (its template's float, bf16, integer and
    bool arguments); the mangled name where it has another form."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled
    end = m.end() + int(m.group(1))
    tpl = mangled[end:].split("EEv")[0]
    args = [a.group(1) or ("bf16" if "bfloat" in a.group(0) else "float")
            for a in re.finditer(r"L[ib](\d+)E|13__nv_bfloat16|(?<=I)f",
                                 tpl)]
    return f"{mangled[m.end():end]}<{', '.join(args)}>"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # torch.compile (the flex_attention yardstick) caches inside the checkout
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(build, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    t_all = time.monotonic()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; tf32 off")
    log(smi)
    t0 = time.monotonic()
    logs = _build.build_all()
    log(f"[build] nvcc sm_90a: {len(logs)} sources built in "
        f"{time.monotonic() - t0:.2f}s")
    for src, text in logs.items():
        fn = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = _kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"[build] {src}: {fn}: {line.strip()}")
    t0 = time.monotonic()
    errs = phase_kernels()
    log(f"[kernels] parity done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    phase_model()
    phase_model_dense()
    phase_model(torch.bfloat16)
    phase_model_dense(torch.bfloat16)
    phase_model_rwkv()
    log(f"[model] done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    phase_model_moe()
    log(f"[model-moe] done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    phase_model_ssm()
    log(f"[model-ssm] done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    launches, llama_params, mars_wall = phase_serve()
    log(f"[serve] done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    obs_launches = phase_serve_obs(llama_params, mars_wall)
    log(f"[serve-obs] done in {time.monotonic() - t0:.2f}s")
    t1 = time.monotonic()
    fault_launches = phase_serve_faults(llama_params)
    log(f"[serve-faults] done in {time.monotonic() - t1:.2f}s")
    t1 = time.monotonic()
    router_launches = phase_serve_router(llama_params)
    log(f"[serve-router] done in {time.monotonic() - t1:.2f}s")
    log(f"[serve-obs] [serve-faults] [serve-router] {time.monotonic() - t0:.2f}s "
        f"together; launches (logged apart; the kernels JSON keeps the "
        f"serve's): {obs_launches}, {fault_launches}, {router_launches}")
    del llama_params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    rows = phase_timing(errs, launches)
    flash_row = phase_flash_timing(errs)
    wkv_row = phase_wkv_timing(errs)
    phase_flash_ssm_timing(errs)
    log(f"[timing] done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    phase_profile()
    log(f"[profile] done in {time.monotonic() - t0:.2f}s")
    gc.collect()                     # the llama weights and pools go first
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    rwkv_launches, rwkv_params = phase_serve_rwkv()
    log(f"[serve-rwkv] done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    phase_profile_rwkv(rwkv_params)
    log(f"[profile-rwkv] done in {time.monotonic() - t0:.2f}s")
    del rwkv_params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    zamba_launches, zamba_params = phase_serve_zamba()
    log(f"[serve-zamba] done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    phase_profile_zamba(zamba_params)
    log(f"[profile-zamba] done in {time.monotonic() - t0:.2f}s")
    del zamba_params                 # free the card for qwen3-coder
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    whisper_launches = phase_serve_whisper()
    log(f"[serve-whisper] done in {time.monotonic() - t0:.2f}s")
    log(f"[serve-zamba] [serve-whisper] prefill launches (logged apart; the "
        f"kernels JSON keeps the dense serve's): {zamba_launches}, "
        f"{whisper_launches}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    moe_launches, backend = phase_serve_moe()
    log(f"[serve-moe] done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    try:
        phase_profile_moe(backend)
    finally:
        backend.close()
    log(f"[profile-moe] done in {time.monotonic() - t0:.2f}s")
    del backend                      # 61 GB of weights: free the card for
    gc.collect()                     # gemma2-27b's ~64 GB
    torch.cuda.empty_cache()
    log(f"[serve-moe] launches (logged apart; the kernels JSON keeps the "
        f"llama serve's): {moe_launches}; device memory after freeing "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.monotonic()
    dense_launches, backend = phase_serve_dense()
    log(f"[serve-dense] done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    try:
        phase_profile_dense(backend)
    finally:
        backend.close()
    log(f"[profile-dense] done in {time.monotonic() - t0:.2f}s")
    del backend                      # free the card for training
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    train_launches = phase_train()
    log(f"[train] launches (logged apart; the kernels JSON keeps the serve "
        f"phases'): {train_launches}")
    log(f"[train] done in {time.monotonic() - t0:.2f}s")
    flash_row["launches"] = dense_launches["flash_attention"]
    wkv_row["launches"] = rwkv_launches["wkv6"]
    rows += [flash_row, wkv_row]
    log(f"[done] {time.monotonic() - t_all:.2f}s; card: {smi}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
