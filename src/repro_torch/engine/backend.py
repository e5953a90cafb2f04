"""Execution backends.

``SimBackend`` — analytic service-time model under a virtual clock. One
engine tick executes a *mixed batch* (Sarathi-style: decode quanta piggyback
prefill chunks); its service time is the max of the compute term (all FLOPs)
and the memory term (weight read once + KV traffic), which naturally models
prefill/decode interference and the benefit of chunking.

``JaxBackend`` lives in ``jax_runner.py`` (real jit'd steps, wall clock).
Both expose the ``PerfOracle`` the policies need (recompute/swap times).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.session import Session
from repro_torch.models import perf_model as pm
from repro_torch.models.config import ModelConfig


@dataclass
class BatchWork:
    """One engine tick's worth of GPU work.

    ``leases`` snapshots every batched session's KV placement (sid -> block
    ids in lease order == token order) at formation time, and ``cow_copies``
    lists the tick's copy-on-write events (sid, src_bid, dst_bid) in order —
    a physical backend executes placement straight from these and never
    re-derives it from the pool (whose state may already have moved on,
    e.g. swap-out releases the lease before the bytes are copied off).

    ``swap_futures`` is the swap-completion handshake: an async backend
    fills it during ``run_batch`` with the transfer future of each swap-out
    it launched on its background stream (sid -> future), and the engine
    attaches those to the host tier right after the batch returns so
    ``HostTier.ready`` gates restores on the real drain, not the model.

    ``mixed`` marks an iteration-level continuous-batching tick (decode
    lanes carry exactly one token each): a physical backend should fuse the
    prefill chunks and decode lanes into a single dispatch rather than
    looping per-session.
    """
    decodes: List[Tuple[Session, int]]        # (session, n_tokens this quantum)
    prefills: List[Tuple[Session, int]]       # (session, chunk_tokens)
    swapins: List[Tuple[Session, int]]        # (session, tokens restored)
    swapouts: List[Tuple[Session, int]] = None  # (session, tokens offloaded)
    leases: Dict[int, Tuple[int, ...]] = None   # sid -> block table snapshot
    cow_copies: List[Tuple[int, int, int]] = None  # (sid, src, dst) in order
    swap_futures: Dict[int, object] = None      # sid -> TransferFuture (D2H)
    mixed: bool = False                         # iteration-level tick

    def __post_init__(self):
        if self.swapouts is None:
            self.swapouts = []
        if self.leases is None:
            self.leases = {}
        if self.cow_copies is None:
            self.cow_copies = []
        if self.swap_futures is None:
            self.swap_futures = {}

    @property
    def empty(self) -> bool:
        return not (self.decodes or self.prefills or self.swapins
                    or self.swapouts)


class SimBackend:
    name = "sim"
    # block accounting IS the KV state in the sim, so attaching to shared
    # radix blocks needs no data movement; a live backend must copy the
    # prefix KV into the attaching session's cache to claim this
    supports_prefix_sharing = True

    def __init__(self, cfg: ModelConfig, hw: pm.HardwareSpec, tp: int = 1):
        self.cfg = cfg
        self.hw = hw
        self.tp = tp
        # cache analytic constants
        self._w_bytes = 2.0 * cfg.param_count(active_only=True)
        self._flops_tok_base = pm.flops_per_token(cfg, 0)

    # --- PerfOracle -----------------------------------------------------------
    def recompute_time(self, n_tokens: int) -> float:
        if n_tokens <= 0:
            return 0.0
        return pm.prefill_time(self.cfg, self.hw, n_tokens, 0, self.tp)

    def swap_time(self, n_tokens: int) -> float:
        return pm.swap_time(self.cfg, self.hw, n_tokens)

    def kv_bytes_per_token(self) -> float:
        """KV footprint per token — sizes the host tier's PCIe cost model."""
        return float(pm.kv_bytes_per_token(self.cfg))

    def prefill_rate(self) -> float:
        """Sustainable prefill tokens/s at a typical agentic context."""
        f = pm.flops_per_token(self.cfg, 64_000)
        return self.hw.peak_flops * self.tp * self.hw.mfu_prefill / f

    # --- execution ---------------------------------------------------------------
    def run_batch(self, work: BatchWork, now: float) -> float:
        """Modeled seconds for one mixed continuous-batching iteration."""
        if work.empty:
            return 0.0
        hw, cfg, tp = self.hw, self.cfg, self.tp
        flops = 0.0
        kv_read = 0.0
        kv_write = 0.0
        for s, g in work.decodes:
            flops += g * pm.flops_per_token(cfg, s.resident_len)
            kv_read += g * pm.kv_cache_bytes(cfg, s.resident_len)
            kv_write += g * pm.kv_bytes_per_token(cfg)
        for s, chunk in work.prefills:
            flops += chunk * pm.flops_per_token(cfg, s.resident_len + chunk // 2)
            kv_write += chunk * pm.kv_bytes_per_token(cfg)
            kv_read += pm.kv_cache_bytes(cfg, s.resident_len)   # attend prefix
        t_compute = flops / (hw.peak_flops * tp * hw.mfu_prefill)
        t_memory = (self._w_bytes / tp + kv_read + kv_write) / \
            (hw.hbm_bw * tp * hw.mbu_decode)
        t = max(t_compute, t_memory)
        # Host<->device KV transfers: the legacy swap path (stock vLLM
        # swapper) serializes with the engine step in both directions. The
        # host tier's batched-DMA path overlaps swap-OUT with the tool
        # phase (HostTier.ready gates restorability), while swap-IN still
        # serializes (decode needs the KV) at the tier's engineered rate
        # (engine stamps ``meta["swap_cost_s"]``).
        for s, toks in work.swapins:
            cost = s.meta.pop("swap_cost_s", None)
            t += self.swap_time(toks) if cost is None else cost
        for s, toks in work.swapouts:
            if not s.meta.get("host_tier"):
                t += self.swap_time(toks)
        return t
