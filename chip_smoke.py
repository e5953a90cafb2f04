"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device    requires CUDA; prints the card and its power limit
2. build     builds the Hopper kernels with nvcc (sm_90a), prints seconds
3. kernels   holds each kernel against its plain PyTorch version on the
             card: the sweeps of tests/test_kernels.py plus the main-path
             shapes, in float32 (atol 2e-5) and bfloat16 (atol 3e-2);
             fused pool writes must be exact
4. model     lm_prefill_paged / lm_decode_paged / lm_mixed_paged of
             llama3.2-1b .reduced() in float32, same weights, on the card
             (kernels) and on the CPU (plain versions): logits and
             non-scratch pages within 1e-4, next tokens equal
5. serve     TorchBackend with llama3.2-1b at full width in bf16 under
             Engine(scheduler="mixed", policy "mars") with real sleep tools:
             8 sessions in two shared-prefix families, 3 rounds; then the
             same with every tool yield forced to OFFLOAD. Kernel launch
             counters are zeroed just before and read just after.
6. timing    each kernel, its plain version and one PyTorch library call
             on the same main-path inputs (CUDA events, warmed), and the
             bound from bytes and operations
7. profile   device time by kernel over one full-width mixed iteration

The line before the last is the kernels JSON line; the last line is the
device JSON line. TF32 is off throughout (float32 parity).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core.events import EventBus  # noqa: E402
from repro_torch.core.policies import KVAction  # noqa: E402
from repro_torch.core.session import Round, make_session  # noqa: E402
from repro_torch.engine.engine import Engine, EngineConfig, run_live  # noqa: E402
from repro_torch.engine.tools import RealToolExecutor  # noqa: E402
from repro_torch.engine.torch_runner import TorchBackend  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_fused)
from repro_torch.kernels.paged_flash_attention import \
    paged_flash_attention  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

F32_TOL, BF16_TOL, MODEL_TOL = 2e-5, 3e-2, 1e-4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
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
}
MAIN_PATH = ("paged_attention_fused", "paged_flash_attention")
DEV = torch.device("cuda")


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


def _check_decode(errs, gen, dtype, tol, B, Hq, Hkv, D, page, P, maxp,
                  lengths=None):
    q, kp, vp, table, lengths = _decode_case(gen, B, Hq, Hkv, D, page, P,
                                             maxp, dtype, lengths=lengths)
    what = f"B={B} Hq={Hq} Hkv={Hkv} D={D} page={page} maxp={maxp}"
    errs.check("paged_attention", dtype,
               paged_attention(q, kp, vp, table, lengths),
               ref.paged_attention_ref(q, kp, vp, table, lengths), tol, what)
    k_new = _randn(gen, (B, Hkv, D), dtype)
    v_new = _randn(gen, (B, Hkv, D), dtype)
    wp, wo = _fused_slots(table, lengths, page)
    kw, vw = kp.clone(), vp.clone()
    kw[wp.long(), wo.long()] = k_new
    vw[wp.long(), wo.long()] = v_new
    want = ref.paged_attention_ref(q, kw, vw, table, lengths)
    o, k2, v2 = paged_attention_fused(q, kp, vp, table, lengths, k_new,
                                      v_new, wp, wo)
    errs.check("paged_attention_fused", dtype, o, want, tol, what)
    errs.exact("paged_attention_fused", k2, kw, what)
    errs.exact("paged_attention_fused", v2, vw, what)


def _check_idle_lanes(errs, gen, dtype, tol):
    """Two live lanes next to idle lanes (length 1, all-scratch table, all
    writing scratch slot 0): live outputs right, non-scratch pages exact."""
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
    errs.check("paged_attention_fused", dtype, o[:2], want, tol, "idle lanes")
    if not torch.isfinite(o.float()).all():
        raise AssertionError("idle lanes produced non-finite outputs")
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


def _check_prefill(errs, gen, dtype, tol, B, Hq, Hkv, D, page, P, Np, Sq,
                   **kw):
    args = _prefill_case(gen, B, Hq, Hkv, D, page, P, Np, Sq, dtype, **kw)
    what = f"B={B} Hq={Hq} Hkv={Hkv} D={D} page={page} Np={Np} Sq={Sq}"
    errs.check("paged_flash_attention", dtype, paged_flash_attention(*args),
               ref.paged_flash_attention_ref(*args), tol, what)


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


def phase_kernels() -> Errors:
    errs = Errors()
    gen = torch.Generator(device=DEV).manual_seed(7)
    decode_sweep = [(4, 8, 2, 64, 32, 64, 8), (2, 4, 4, 128, 16, 32, 4),
                    (1, 16, 8, 64, 32, 16, 6), (3, 6, 2, 64, 8, 40, 10),
                    (2, 4, 2, 64, 16, 16, 4)]
    prefill_sweep = [(2, 4, 2, 64, 32, 8, 4, 64), (1, 8, 8, 64, 16, 6, 6, 64),
                     (2, 2, 1, 128, 32, 8, 4, 32),
                     (1, 4, 2, 64, 32, 8, 8, 96), (2, 4, 2, 64, 32, 8, 4, 33),
                     (2, 4, 2, 64, 32, 8, 4, 7), (1, 4, 2, 64, 32, 8, 4, 1),
                     (2, 4, 2, 32, 32, 8, 4, 64)]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for shape in decode_sweep:
            _check_decode(errs, gen, dtype, tol, *shape)
        # main path: Hq 32, Hkv 8, D 64, page 32, contexts up to 2k
        _check_decode(errs, gen, dtype, tol, 8, 32, 8, 64, 32, 600, 64)
        _check_decode(errs, gen, dtype, tol, 8, 32, 8, 64, 32, 600, 64,
                      lengths=[2048, 1, 33, 1024, 1500, 700, 64, 1999])
        _check_idle_lanes(errs, gen, dtype, tol)
        for shape in prefill_sweep:
            _check_prefill(errs, gen, dtype, tol, *shape)
        # main path: chunks up to the token budget over up to 2k context
        for C, kv in ((512, 2048), (256, 1280), (200, 1000), (32, 32)):
            _check_prefill(errs, gen, dtype, tol, 1, 32, 8, 64, 32, 80, 66,
                           C, kv_len=[kv], table_ids=80)
        _check_shared_prefix_rows(dtype, gen)
    torch.cuda.synchronize()
    for (name, dt), err in sorted(errs.max.items()):
        log(f"[kernels] {name:22s} {dt:9s} max_abs_err={err:.3e}")
    return errs


# ---------------------------------------------------------------------------
# 4. model parity: card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------

def _to_device(tree):
    if isinstance(tree, dict):
        return {k: _to_device(v) for k, v in tree.items()}
    return tree.to(DEV)


def phase_model() -> None:
    cfg = get_config("llama3.2-1b").reduced()
    params = tf.init_lm(cfg, torch.Generator().manual_seed(0), torch.float32)
    dparams = _to_device(params)
    page, P, Np = 32, 12, 4
    scratch = P - 1
    rng = np.random.default_rng(3)
    shp = (cfg.n_layers, P, page, cfg.n_kv_heads, cfg.head_dim_)
    k0 = torch.from_numpy(rng.standard_normal(shp, np.float32) * 0.5)
    v0 = torch.from_numpy(rng.standard_normal(shp, np.float32) * 0.5)
    cpu = tf.PagedKVCache(k0.clone(), v0.clone())
    gpu = tf.PagedKVCache(k0.to(DEV), v0.to(DEV))
    worst = 0.0

    def agree(a, b, what):
        nonlocal worst
        err = (a.float().cpu() - b.float()).abs().max().item()
        worst = max(worst, err)
        if not err <= MODEL_TOL:
            raise AssertionError(f"model {what}: max abs err {err}")

    def pools(what):
        live = [p for p in range(P) if p != scratch]
        agree(gpu.k[:, live], cpu.k[:, live], what + " k pages")
        agree(gpu.v[:, live], cpu.v[:, live], what + " v pages")

    def both(fn, *args):
        a = fn(cfg, params, cpu, *(torch.as_tensor(x) for x in args))
        b = fn(cfg, dparams, gpu, *(torch.as_tensor(x).to(DEV)
                                    for x in args))
        return a, b

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
                                np.int32(start + n))
        agree(lg[:, :n], lc[:, :n], f"prefill logits @{start}")
        pools(f"prefill @{start}")
    # decode: lanes at 53 (continuing), 70 and 5 (pool garbage as context)
    tables = np.array([[0, 1, scratch], [2, 3, 4], [5, scratch, scratch],
                       [scratch] * 3], np.int32)
    lens = np.array([53, 70, 5, 1], np.int32)
    wp = np.array([1, 4, 5, scratch], np.int32)
    wo = np.array([52 % page, 69 % page, 4, 0], np.int32)
    toks = np.array([7, 9, 11, 0], np.int32)
    (lc, _), (lg, _) = both(tf.lm_decode_paged, toks, lens - 1, tables, lens,
                            wp, wo)
    agree(lg[:3], lc[:3], "decode logits")
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
        tables, lens2, wp, wo2)
    if pc.tolist() != pg.cpu().tolist() or \
            dc[:3].tolist() != dg[:3].cpu().tolist():
        raise AssertionError(f"mixed next tokens differ: {pc}/{dc} vs "
                             f"{pg}/{dg}")
    pools("mixed")
    log(f"[model] llama3.2-1b reduced f32: card vs cpu max abs err "
        f"{worst:.3e} (tol {MODEL_TOL}); mixed next tokens equal")


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


def _serve(backend, run: int, *, force_offload: bool):
    bus = EventBus()
    tools = RealToolExecutor(cpu_slots=4, bus=bus)
    eng = Engine(EngineConfig(total_kv_blocks=SERVE["total_pages"],
                              block_size=32, token_budget=512,
                              max_decode_batch=8, cpu_slots=4,
                              scheduler="mixed"),
                 "mars", backend, bus=bus, tool_exec=tools)
    if force_offload:
        eng.policy.on_tool_yield = lambda s, now: (KVAction.OFFLOAD, 0.0)
    sessions = _sessions(run)
    try:
        t0 = time.monotonic()
        finished, horizon = run_live(eng, sessions, timeout=300)
        wall = time.monotonic() - t0
    finally:
        tools.shutdown()
    eng.check_invariants()
    label = "offload" if force_offload else "mars"
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
    if eng.prefix_hit_tokens <= 0:
        raise AssertionError(f"serve[{label}]: no prefix hits")
    if force_offload and not outs:
        raise AssertionError("serve[offload]: no host SWAP_OUT")
    if eng.blocks.cow_count <= 0:
        raise AssertionError(f"serve[{label}]: no copy-on-write ran")
    return eng


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
    for k in KERNELS.values():
        k["fn"].launches = 0
    try:
        _serve(backend, 0, force_offload=False)
        eng = _serve(backend, 1, force_offload=True)
    finally:
        backend.close()
    launches = {name: k["fn"].launches for name, k in KERNELS.items()}
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
    return launches


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


def _bound(nbytes: float, flops: float, peak: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _dense_kv(pages, table):
    """(B, Hkv, Np*page, D) dense copy of the table's pages (for SDPA)."""
    B, Np = table.shape
    _, page, Hkv, D = pages.shape
    return pages[table.long()].reshape(B, Np * page, Hkv, D).transpose(1, 2)


def phase_timing(errs: Errors, launches):
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(11)
    bf16, item = torch.bfloat16, 2
    B, Hq, Hkv, D, page, maxp, P = 8, 32, 8, 64, 32, 64, 4096
    G = Hq // Hkv
    rows = []
    # decode lanes as the serve phase sees them: ~1.1k-1.4k context
    lens = torch.tensor([1090, 1131, 1160, 1188, 1216, 1270, 1310, 1377],
                        device=DEV).int()
    q, kp, vp, table, lens = _decode_case(gen, B, Hq, Hkv, D, page, P, maxp,
                                          bf16, lengths=lens)
    k_new = _randn(gen, (B, Hkv, D), bf16)
    v_new = _randn(gen, (B, Hkv, D), bf16)
    wp, wo = _fused_slots(table, lens, page)
    kp[wp.long(), wo.long()] = k_new     # the slots hold the new tokens, so
    vp[wp.long(), wo.long()] = v_new     # every version sees the same pool
    n_kv = float(lens.sum().item())
    for name in ("paged_attention_fused", "paged_attention"):
        fused = name == "paged_attention_fused"
        if fused:
            run = (lambda: paged_attention_fused(q, kp, vp, table, lens,
                                                 k_new, v_new, wp, wo))

            def plain():
                kp[wp.long(), wo.long()] = k_new
                vp[wp.long(), wo.long()] = v_new
                return ref.paged_attention_ref(q, kp, vp, table, lens)
            kv_read = n_kv - B
        else:
            run = (lambda: paged_attention(q, kp, vp, table, lens))
            plain = (lambda: ref.paged_attention_ref(q, kp, vp, table, lens))
            kv_read = n_kv
        nbytes = (2 * kv_read * Hkv * D * item + 2 * B * Hq * D * item
                  + (4 * B * Hkv * D * item if fused else 0)
                  + table.numel() * 4 + B * 4 * (3 if fused else 1))
        flops = 4.0 * n_kv * Hq * D
        kd, vd = _dense_kv(kp, table), _dense_kv(vp, table)
        mask = (torch.arange(maxp * page, device=DEV)[None]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = (lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask, enable_gqa=True))
        rows.append((name, run, plain, lib, nbytes, flops))
    # a prefill pack as the serve phase sees it: C=256 of a ~1.3k context
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
    rows.append(("paged_flash_attention",
                 lambda: paged_flash_attention(qp, kpp, vpp, tablep, kvl, qo),
                 lambda: ref.paged_flash_attention_ref(qp, kpp, vpp, tablep,
                                                       kvl, qo),
                 lambda: F.scaled_dot_product_attention(
                     qp, kdp, vdp, attn_mask=pmask, enable_gqa=True),
                 nbytes, flops))
    # the SDPA yardsticks compute the same function
    for name, run, plain, lib, *_ in rows:
        got = run()[0] if name == "paged_attention_fused" else run()
        want = lib()
        want = want[:, :, 0] if want.dim() == 4 and got.dim() == 3 else want
        errs.check(name, "sdpa_bf16", got, want, BF16_TOL, "vs library")
    out = []
    for name, run, plain, lib, nbytes, flops in rows:
        bound, by = _bound(nbytes, flops, BF16_FLOPS)
        k_ms, p_ms, l_ms = time_ms(run), time_ms(plain), time_ms(lib)
        out.append({
            "name": name, "route": "cuda", "source": KERNELS[name]["source"],
            "replaces": KERNELS[name]["replaces"],
            "launches": launches[name],
            "max_abs_err": max(v for (n, dt), v in errs.max.items()
                               if n == name and dt != "sdpa_bf16"),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": l_ms})
        log(f"[timing] {name:22s} kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
            f"sdpa {l_ms:.4f} ms  bound {bound:.4f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)  "
            f"bound/kernel {bound / k_ms:.3f}")
    return out


# ---------------------------------------------------------------------------
# 7. profile one full-width mixed iteration
# ---------------------------------------------------------------------------

def phase_profile():
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("llama3.2-1b")
    params = tf.init_lm(cfg, torch.Generator(device=DEV).manual_seed(1),
                        torch.bfloat16, DEV)
    page, P, Np, C, B = 32, 1024, 64, 256, 8
    cache = tf.PagedKVCache.zeros(cfg, P + 1, page, torch.bfloat16, DEV)
    lens = np.array([1090, 1131, 1160, 1188, 1216, 1270, 1310, 1377],
                    np.int32)
    d_tables = np.arange(B * Np, dtype=np.int32).reshape(B, Np) % P
    i32 = (lambda a: torch.as_tensor(np.asarray(a, np.int32), device=DEV))
    args = (i32(np.zeros((1, 1, C))), i32((1024 + np.arange(C))[None, None]),
            i32(np.arange(Np)[None] + 512), i32(512 + (1024 + np.arange(C))
                                                [None] // page),
            i32((1024 + np.arange(C))[None] % page), i32([1024 + C]),
            i32([C - 1]), i32(np.zeros(B)), i32(lens - 1), i32(d_tables),
            i32(lens), i32(d_tables[np.arange(B), (lens - 1) // page]),
            i32((lens - 1) % page))
    for _ in range(2):
        tf.lm_mixed_paged(cfg, params, cache, *args)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(5):
        tf.lm_mixed_paged(cfg, params, cache, *args)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / 5     # profiler off
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            tf.lm_mixed_paged(cfg, params, cache, *args)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_time_total", 0) > 0
           and "CUDA" in str(getattr(e, "device_type", ""))]
    total = sum(e.device_time_total for e in evs) / 3e3
    log(f"[profile] lm_mixed_paged full width, 1 pack C={C} + {B} decode "
        f"lanes: wall {wall_ms:.3f} ms/iter (profiler off), device "
        f"{total:.3f} ms/iter, idle share "
        f"{max(0.0, 1 - total / wall_ms):.3f}")
    for e in sorted(evs, key=lambda e: -e.device_time_total)[:8]:
        log(f"[profile]   {e.device_time_total / 3e3:9.3f} ms/iter "
            f"x{e.count // 3:4d}  {e.key[:90]}")
    if not evs:
        log("[profile] no device time in the trace: not measured")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")
    t0 = time.monotonic()
    errs = phase_kernels()
    log(f"[kernels] parity done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    phase_model()
    log(f"[model] done in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    launches = phase_serve()
    log(f"[serve] done in {time.monotonic() - t0:.2f}s")
    rows = phase_timing(errs, launches)
    phase_profile()
    log(f"[done] {time.monotonic() - t_all:.2f}s; card: {smi}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
