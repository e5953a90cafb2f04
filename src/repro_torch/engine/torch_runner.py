"""Live PyTorch execution backend: the same Engine/tick loop as
``repro.engine.jax_runner``, but ``run_batch`` runs the model with PyTorch
and the Hopper attention kernels, and returns wall-clock seconds.

Two cache layouts, as in the reference:

* **paged** (default) — a global pool of KV pages ``(L, P+1, page, Hkv,
  D)`` driven by ``kvcache.pool.BlockPool`` block tables. The engine
  snapshots each batched session's lease into ``BatchWork.leases`` and this
  backend executes placement from those tables: prefill scatters chunk KV
  into leased pages and attends gather-free over the lease
  (``paged_flash_attention`` reads pages in place), decode feeds
  ``(B, max_pages)`` tables to ``paged_attention_fused`` with the new
  token's KV write inside the kernel, copy-on-write events are mirrored as
  device page copies, and host offload moves KV per block (only private
  blocks cross PCIe). Page id P (one past the pool) is scratch: padded
  prefill lanes and idle decode lanes park their writes there.

* **dense** — R fixed slots, each a dense ``max_len``-token region
  (``KVCache`` ``(L, R, max_len, Hkv, D)``; position ``max_len - 1`` is the
  slot's scratch). The path for attention variants the paged kernels do
  not cover (sliding-window alternation, logit softcaps: gemma2), and the
  parity baseline of the paged path. Prefill chunks run the ``flash_attention``
  kernel over the slot in place; decode steps every slot through the plain
  ``layers.attention``, as the reference does; host offload copies whole
  slots, synchronously.

Unlike JAX's donated buffers, the cache tensors are updated **in place**;
a swap-out snapshot is therefore a real copy, taken in dispatch order on
the compute stream before any later write. On the card the paged layout's
host crossings run on side CUDA streams driven by the background
:class:`SwapStream` worker, into pinned host memory.

Chunks and lane counts are bucketed to powers of two, as in the reference,
so the same shapes recur. The PerfOracle (recompute_time / prefill_rate /
swap_time) is calibrated at startup by timing one prefill chunk, one
decode step and one page (or slot) round trip, synchronising the card
inside each timed region.
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.session import Session
from repro_torch.engine.backend import BatchWork
from repro_torch.kvcache.disk_tier import DiskFileStore
from repro_torch.kvcache.pool import DeviceBindingMap
from repro_torch.kvcache.swap_stream import SwapStream, TransferFuture
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (KVCache, PagedKVCache, init_lm,
                                            lm_decode, lm_decode_paged,
                                            lm_mixed_paged, lm_prefill_paged,
                                            lm_step, supports_paged)
from repro_torch.obs import spans


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class TorchBackend:
    name = "torch"

    def __init__(self, cfg: ModelConfig, *, params=None, layout: str = "paged",
                 max_slots: int = 8, max_len: int = 1024,
                 total_pages: Optional[int] = None, page_size: int = 32,
                 seed: int = 0, device="cuda", dtype=torch.bfloat16,
                 async_swap: bool = True, disk_spool: Optional[str] = None):
        # the card unless the caller asks for the CPU: no card raises,
        # it never carries on on the CPU
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain PyTorch "
                               "versions on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r}: the live runner serves the LM "
                "families, dense and moe (ROADMAP.md, 'Modules still to "
                "port')")
        if layout not in ("paged", "dense"):
            raise ValueError(f"unknown layout {layout!r}")
        if layout == "paged" and not supports_paged(cfg):
            layout = "dense"          # window/softcap: no paged kernel
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.dtype = dtype
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_lm(cfg, gen, dtype, self.device)
        self.params = params
        self.layout = layout
        if layout == "paged":
            if total_pages is None:
                total_pages = max(1, max_slots * max_len // page_size)
            self._impl = _PagedLayout(self, total_pages, page_size,
                                      async_swap=async_swap,
                                      disk_spool=disk_spool)
        else:
            self._impl = _DenseLayout(self)
        # prefix sharing needs placement to follow block ids physically;
        # a real decoder also needs the last prompt token's logits, so a
        # full prefix hit must still leave >= 1 token to compute
        self.supports_prefix_sharing = layout == "paged"
        self.requires_last_token_compute = layout == "paged"
        # async swap stream: D2H drains and H2D prefetches run on a
        # background worker; the engine gates restores on their futures
        # (the dense layout swaps whole slots synchronously)
        self.supports_async_swap = layout == "paged" and async_swap
        # live-path dispatch timing, same keys as JaxBackend.dispatch_stats:
        # cumulative wall seconds per run_batch phase + call counts, and the
        # analytic prefill HBM bytes of the gather path vs the in-place path
        self.dispatch_stats: Dict[str, float] = {
            "batches": 0, "wall_s": 0.0,
            "swap_out_s": 0.0, "cow_s": 0.0, "swap_in_s": 0.0,
            "prefill_s": 0.0, "decode_s": 0.0,
            "prefill_calls": 0, "decode_calls": 0,
            "mixed_s": 0.0, "mixed_calls": 0,
            "prefill_gather_bytes": 0.0, "prefill_inplace_bytes": 0.0,
        }
        self._impl.calibrate()

    # --- engine binding ---------------------------------------------------
    def bind_kv_pool(self, pool) -> None:
        """Engine handshake: validates that the engine's BlockPool fits the
        physical page pool; placement arrives through ``BatchWork.leases``."""
        self._impl.bind_kv_pool(pool)

    def release_session(self, sid: int) -> None:
        self._impl.release_session(sid)

    def drop_host(self, sid: int) -> None:
        self._impl.drop_host(sid)

    def prefetch_swap_in(self, sid: int) -> Optional[TransferFuture]:
        """Launch the H2D crossing of ``sid``'s private host blocks on the
        background stream (None when nothing private was offloaded)."""
        return self._impl.prefetch_swap_in(sid)

    def spill_host(self, sid: int) -> Optional[TransferFuture]:
        """NVMe demotion data plane: write ``sid``'s host KV copy to the
        spool directory (freeing the DRAM copy) on the background stream."""
        return self._impl.spill_host(sid)

    def fill_host(self, sid: int) -> Optional[TransferFuture]:
        """NVMe promotion data plane: read ``sid``'s spool file back into
        the host copy ahead of the PCIe swap-in."""
        return self._impl.fill_host(sid)

    def close(self) -> None:
        """Stop the background swap stream and remove the spool."""
        self._impl.close()

    # --- oracle (calibrated) ----------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _time_once(self, fn) -> float:
        fn()                                      # warm up
        self._sync()
        t0 = time.monotonic()
        fn()
        self._sync()
        return max(1e-6, time.monotonic() - t0)

    def recompute_time(self, n_tokens: int) -> float:
        return n_tokens * self._prefill_s_per_tok

    def prefill_rate(self) -> float:
        return 1.0 / self._prefill_s_per_tok

    def swap_time(self, n_tokens: int) -> float:
        """Measured host<->device KV bandwidth for the copy path."""
        return 1e-3 + n_tokens * self.kv_bytes_per_token() / self._h2d_bw

    def kv_bytes_per_token(self) -> float:
        return self._impl.kv_bytes_per_token()

    # --- execution --------------------------------------------------------
    def run_batch(self, work: BatchWork, now: float) -> float:
        if work.empty:
            return 0.0
        st = self.dispatch_stats
        # one set of boundaries (spans.clock, monotonic) times the phases'
        # spans and dispatch_stats alike
        t0 = spans.clock()
        impl = self._impl
        with spans.root("run_batch", t0) as top:
            # device-write ordering within a tick: D2H snapshots of
            # swapped-out pages first (their ids may be re-leased to this
            # very batch), then CoW page copies (their sources may be about
            # to be overwritten), then H2D restores, then compute writes
            ph = spans.begin("swap_out", t0)
            for s, _toks in work.swapouts:
                fut = impl.swap_out(s)
                if fut is not None:
                    work.swap_futures[s.sid] = fut
            t1 = spans.clock()
            ph.end(t1)
            ph = spans.begin("cow", t1)
            impl.apply_cow(work.cow_copies)
            t2 = spans.clock()
            ph.end(t2)
            ph = spans.begin("swap_in", t2)
            for s, _toks in work.swapins:
                impl.swap_in(s, work.leases.get(s.sid, ()))
            t3 = spans.clock()
            ph.end(t3)
            if work.mixed and (work.prefills or work.decodes) and \
                    isinstance(impl, _PagedLayout):
                # iteration-level tick on the paged layout: prefill packs +
                # decode lanes in one lm_mixed_paged call (attributed to
                # mixed_s; its span is run_mixed's own); the dense layout
                # takes the round path below
                impl.run_mixed(work)
                t4 = t5 = spans.clock()
                st["mixed_s"] += (t4 - t3) * 1e-9
                st["mixed_calls"] += 1
            else:
                ph = spans.begin("prefill", t3)
                for s, chunk in work.prefills:
                    impl.prefill(s, chunk, work.leases.get(s.sid, ()))
                t4 = spans.clock()
                ph.end(t4)
                ph = spans.begin("decode", t4)
                if work.decodes:
                    impl.decodes(work.decodes, work.leases)
                t5 = spans.clock()
                ph.end(t5)
                st["prefill_s"] += (t4 - t3) * 1e-9
                st["decode_s"] += (t5 - t4) * 1e-9
            top.end(t5)
        st["batches"] += 1
        st["swap_out_s"] += (t1 - t0) * 1e-9
        st["cow_s"] += (t2 - t1) * 1e-9
        st["swap_in_s"] += (t3 - t2) * 1e-9
        st["wall_s"] += (t5 - t0) * 1e-9
        st["prefill_calls"] += len(work.prefills)
        st["decode_calls"] += len(work.decodes)
        return (t5 - t0) * 1e-9

    def swap_stream_stats(self) -> Optional[Dict]:
        """Background stream counters (None without a stream, as for the
        dense layout, which swaps synchronously)."""
        stream = self._impl.stream
        return stream.stats() if stream is not None else None

    def bind_cpu_pool(self, pool) -> None:
        """Engine hook: the swap stream's worker holds a core from the
        shared pool while a crossing executes. No-op without a stream."""
        if self._impl.stream is not None:
            self._impl.stream.cpu_pool = pool

    # --- deterministic synthetic context ----------------------------------
    def _context_ids(self, s: Session) -> List[int]:
        """Token ids are *content-addressed*, exactly as in the JAX
        backend: round-0 chunks derive from their prefix-hash keys and
        everything beyond draws by (sid, absolute position)."""
        ids = s.meta.setdefault("context_ids", [])
        target = s.prefill_target
        # a round evacuated mid-tool (router failover) is decoded again on
        # its new home: drop the tokens its first decode left behind, so
        # the round is neither counted nor put in the context twice
        gen = s.meta.get("generated")
        done = sum(r.decode_tokens for r in s.rounds[:s.cur_round])
        if gen is not None and len(gen) > done + s.decoded:
            del gen[done + s.decoded:]
            del ids[target + s.decoded:]
        V = self.cfg.vocab_size
        hashes = s.meta.get("prefix_hashes")
        if hashes:
            round0 = sum(n for _, n in hashes)
            if len(ids) < round0:          # (no decode happened yet: round 0
                ids.clear()                #  must fully prefill first)
                for key, n in hashes:
                    rng = np.random.default_rng(
                        zlib.crc32(repr(key).encode()))
                    ids.extend(int(x) for x in rng.integers(2, V, size=n))
                spans.count("context_tokens_synthesized", len(ids))
        n0 = len(ids)
        while len(ids) < target:
            pos = len(ids)
            ids.append(int(np.random.default_rng((s.sid, pos))
                           .integers(2, V)))
        spans.count("context_tokens_synthesized", len(ids) - n0)
        return ids


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host tensor -> numpy for the spool (bf16 travels as its int16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(dtype) if dtype == torch.bfloat16 else t


class _PagedLayout:
    """Global page pool driven by BlockPool block tables.

    With ``async_swap`` (default) the host crossings run on a background
    :class:`SwapStream`: ``swap_out`` gathers the private pages into a
    device-side snapshot (a copy, in dispatch order) and hands the D2H
    drain to the worker; ``prefetch_swap_in`` uploads the host copy to
    standalone device buffers ahead of the restore, so ``swap_in`` only
    pays a device-side scatter.
    """

    def __init__(self, backend: TorchBackend, total_pages: int, page: int,
                 async_swap: bool = True, disk_spool: Optional[str] = None):
        self.b = backend
        self.dev = backend.device
        self.page = page
        self.total_pages = total_pages
        # NVMe spill data plane, created lazily on the first spill
        self._spool_dir = disk_spool
        self._filestore: Optional[DiskFileStore] = None
        self.binding = DeviceBindingMap(total_pages)
        self.scratch = self.binding.scratch_page
        self.cache = PagedKVCache.zeros(backend.cfg, total_pages + 1, page,
                                        backend.dtype, self.dev)
        # host copies of offloaded private blocks:
        # sid -> (k (L, n, page, Hkv, D), v (...)) in swap-record order
        self._host: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.stream: Optional[SwapStream] = (SwapStream(n_buffers=2)
                                             if async_swap else None)
        # side CUDA streams for the host crossings (card only)
        on_card = self.dev.type == "cuda"
        self._d2h_stream = torch.cuda.Stream(self.dev) if on_card else None
        self._h2d_stream = torch.cuda.Stream(self.dev) if on_card else None
        # async state, all guarded by _mu: in-flight D2H futures, prefetched
        # device buffers (with their upload events), and the sids whose
        # host state was dropped while a transfer was in flight
        self._mu = threading.Lock()
        self._d2h: Dict[int, TransferFuture] = {}
        self._prefetch: Dict[int, tuple] = {}
        self._dropped: set = set()

    # --- device arrays and the compute calls ------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def _decode_fn(self, tokens, positions, tables, lengths, wpid, woff):
        b = self.b
        logits, self.cache = lm_decode_paged(
            b.cfg, b.params, self.cache, self._t(tokens), self._t(positions),
            tables, self._t(lengths), self._t(wpid), self._t(woff))
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _prefill_fn(self, tokens, positions, table, wpid, woff, kv_len,
                    last_idx):
        b = self.b
        logits, self.cache = lm_prefill_paged(
            b.cfg, b.params, self.cache, self._t(tokens), self._t(positions),
            self._t(table), self._t(wpid), self._t(woff),
            self._t(np.int32(kv_len)))
        return torch.argmax(logits[0, last_idx], dim=-1).to(torch.int32)

    def _copy_fn(self, src: int, dst: int) -> None:
        self.cache.k[:, dst].copy_(self.cache.k[:, src])
        self.cache.v[:, dst].copy_(self.cache.v[:, src])

    # --- binding / oracle -------------------------------------------------
    def bind_kv_pool(self, pool) -> None:
        if pool.block_size != self.page:
            raise ValueError(f"pool block_size {pool.block_size} != page "
                             f"{self.page}")
        if pool.total > self.total_pages:
            raise ValueError(f"pool of {pool.total} blocks exceeds "
                             f"{self.total_pages} pages")

    def kv_bytes_per_token(self) -> float:
        k = self.cache.k             # (L, P, page, Hkv, D)
        per_tok = 2 * k.numel() // (k.shape[1] * k.shape[2]) * k.element_size()
        return float(per_tok)

    def calibrate(self) -> None:
        """Time one 64-token prefill chunk, one decode step and one page
        round trip, all parked on the scratch page (the calibration writes
        go there), synchronising the card inside each timed region."""
        b = self.b
        C = 64
        toks = np.zeros((1, C), np.int32)
        pos = np.arange(C, dtype=np.int32)[None]
        Np = _bucket(C // self.page + 1, lo=2)
        table = np.full((Np,), self.scratch, np.int32)
        wpid = np.full((C,), self.scratch, np.int32)
        woff = np.arange(C, dtype=np.int32) % self.page

        def pf():
            int(self._prefill_fn(toks, pos, table, wpid, woff, C, C - 1))

        b._prefill_s_per_tok = b._time_once(pf) / C
        B = _bucket(b.max_slots, lo=1)
        tok1 = np.zeros((B,), np.int32)
        pos1 = np.zeros((B,), np.int32)
        tables = self._t(np.full((B, 2), self.scratch, np.int32))
        lens = np.ones((B,), np.int32)
        wp = np.full((B,), self.scratch, np.int32)
        wo = np.zeros((B,), np.int32)

        def df():
            self._decode_fn(tok1, pos1, tables, lens, wp, wo).cpu()

        b._decode_s_per_step = b._time_once(df)
        page_bytes = 2 * self.cache.k[:, 0].numel() * \
            self.cache.k.element_size()

        def xfer():
            host = (self.cache.k[:, 0].cpu(), self.cache.v[:, 0].cpu())
            host[0].to(self.dev)
            host[1].to(self.dev)
            b._sync()

        # round trip moves page_bytes each way; swap_time charges one
        # direction per call, so price it at the two-direction average
        b._h2d_bw = max(1e6, 2 * page_bytes / b._time_once(xfer))

    # --- session / host state ---------------------------------------------
    def release_session(self, sid: int) -> None:
        pass                         # placement is the engine's lease state

    def drop_host(self, sid: int) -> None:
        with self._mu:
            self._host.pop(sid, None)
            self._prefetch.pop(sid, None)
            self._d2h.pop(sid, None)
            if self.stream is not None:
                self._dropped.add(sid)   # in-flight jobs must not resurrect
        if self._filestore is not None:
            self._filestore.delete(sid)

    def close(self) -> None:
        if self.stream is not None:
            self.stream.close()
        if self._filestore is not None:
            self._filestore.close()
            self._filestore = None

    # --- host crossings ---------------------------------------------------
    def _to_host(self, ready: Optional[torch.cuda.Event], *snaps):
        """D2H copies of device snapshots into pinned host memory on the
        side stream, after ``ready`` (recorded behind the gather); returns
        once the bytes have landed."""
        if self._d2h_stream is None:
            return snaps                 # CPU device: the snapshot is host
        with torch.cuda.stream(self._d2h_stream):
            self._d2h_stream.wait_event(ready)
            out = []
            for t in snaps:
                t.record_stream(self._d2h_stream)
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                out.append(h)
        self._d2h_stream.synchronize()
        return tuple(out)

    def _to_device(self, *hosts):
        """H2D upload of host tensors on the side stream; returns the
        device buffers and the event recorded after the copies, once the
        copies have finished."""
        if self._h2d_stream is None:
            return (*hosts, None)
        with torch.cuda.stream(self._h2d_stream):
            out = [h.to(self.dev, non_blocking=True) for h in hosts]
            ev = torch.cuda.Event()
            ev.record(self._h2d_stream)
        self._h2d_stream.synchronize()
        return (*out, ev)

    # --- NVMe spill/fill (TieredStore data plane) -------------------------
    def _store(self) -> DiskFileStore:
        if self._filestore is None:
            self._filestore = DiskFileStore(self._spool_dir)
        return self._filestore

    def spill_host(self, sid: int) -> Optional[TransferFuture]:
        """Write ``sid``'s host KV copy to the spool and free the DRAM
        copy; on the stream when one runs, synchronously otherwise. Empty
        records keep their (None, None) marker in DRAM."""
        store = self._store()

        def write() -> bool:
            with self._mu:
                if self.stream is not None and sid in self._dropped:
                    return False
                host = self._host.get(sid)
            if host is None or host[0] is None:
                return False           # nothing private: marker stays
            store.write(sid, _to_numpy(host[0]), _to_numpy(host[1]))
            with self._mu:
                if self.stream is not None and sid in self._dropped:
                    store.delete(sid)  # raced a detach: no resurrection
                    return False
                self._host.pop(sid, None)
            return True

        if self.stream is None:
            write()
            return None
        return self.stream.submit(write, sid=sid, direction="h2n")

    def fill_host(self, sid: int) -> Optional[TransferFuture]:
        """Read ``sid``'s spool file back into the host copy (promotion
        first hop); the normal prefetch/swap-in path then moves it over
        PCIe."""
        store = self._store()
        dtype = self.b.dtype

        def read() -> bool:
            data = store.read(sid)
            if data is None:
                return False           # empty record: marker never spilled
            host = (_from_numpy(data[0], dtype), _from_numpy(data[1], dtype))
            with self._mu:
                if self.stream is not None and sid in self._dropped:
                    store.delete(sid)
                    return False
                self._host[sid] = host
            store.delete(sid)
            return True

        if self.stream is None:
            read()
            return None
        return self.stream.submit(read, sid=sid, direction="n2h")

    # --- swap: per-block host offload -------------------------------------
    def swap_out(self, s: Session) -> Optional[TransferFuture]:
        """D2H-copy only the blocks flagged private in the engine's swap
        record. The page gather (a device-side copy, ordered before any
        later pool write) happens here; the host crossing drains on the
        worker and its future joins the swap-completion handshake."""
        rec = s.meta.get("swap_pages")
        if rec is None:
            return None
        sid = s.sid
        pids = [self.binding.page_of(bid) for bid, _gen, private in rec
                if private]
        if not pids:
            if self.stream is None:
                self._host[sid] = (None, None)
                return None

            def mark_empty():
                # through the FIFO: a stale drain for this sid still queued
                # from a dropped earlier offload must land first
                with self._mu:
                    self._dropped.discard(sid)
                    self._host[sid] = (None, None)

            return self.stream.submit(mark_empty, sid=sid, direction="d2h")
        # scratch-padded power-of-two gather width, as in the reference
        idx = self._t(self._swap_index(pids)).long()
        if self.stream is None:
            self._host[sid] = (self.cache.k[:, idx].cpu(),
                               self.cache.v[:, idx].cpu())
            return None
        slot = self.stream.staging.acquire()     # double-buffer backpressure
        k_snap = self.cache.k[:, idx]            # device-side staging copy
        v_snap = self.cache.v[:, idx]
        ready = None
        if self._d2h_stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.dev))
        with self._mu:
            self._dropped.discard(sid)

        def drain():
            try:
                host = self._to_host(ready, k_snap, v_snap)
                with self._mu:
                    if sid not in self._dropped:
                        self._host[sid] = host
                return host
            finally:
                self.stream.staging.release(slot)

        fut = self.stream.submit(drain, sid=sid, direction="d2h")
        with self._mu:
            self._d2h[sid] = fut
        return fut

    def prefetch_swap_in(self, sid: int) -> Optional[TransferFuture]:
        """Upload ``sid``'s private host blocks to standalone device
        buffers on the worker; the later ``swap_in`` scatters them into
        the freshly leased pages. Only callable once the D2H drain
        resolved (``HostTier.ready`` gates the engine)."""
        with self._mu:
            host = self._host.get(sid)
        if self.stream is None or host is None or host[0] is None:
            return None
        slot = self.stream.staging.acquire()

        def upload():
            try:
                dk, dv, ev = self._to_device(host[0], host[1])
                with self._mu:
                    if sid not in self._dropped:
                        self._prefetch[sid] = (dk, dv, ev)
                return (dk, dv)
            finally:
                self.stream.staging.release(slot)

        return self.stream.submit(upload, sid=sid, direction="h2d")

    def swap_in(self, s: Session, lease) -> None:
        """Restore private blocks into the freshly allocated pages at
        ``meta["restore_positions"]``; reacquired shared blocks need no
        transfer. A prefetched restore scatters device-resident buffers
        (after the compute stream waits on their upload); otherwise the H2D
        upload happens inline (after waiting out a same-tick D2H)."""
        sid = s.sid
        with self._mu:
            d2h = self._d2h.pop(sid, None)
        if d2h is not None and not d2h.done():
            d2h.result()      # same-tick out->in: restore behind the drain
        with self._mu:
            pre = self._prefetch.pop(sid, None)
            host = self._host.pop(sid, None)
        if host is None or host[0] is None:
            return
        restore = s.meta.get("restore_positions", [])
        pids = [self.binding.page_of(lease[i]) for i in restore]
        if _bucket(len(pids), lo=2) != host[0].shape[1]:
            raise RuntimeError(f"restore mismatch: {len(pids)} pages, "
                               f"{host[0].shape[1]} copies")
        idx = self._t(self._swap_index(pids)).long()
        if pre is not None:
            dk, dv, ev = pre
            if ev is not None:
                cur = torch.cuda.current_stream(self.dev)
                cur.wait_event(ev)
                dk.record_stream(cur)
                dv.record_stream(cur)
        else:
            dk, dv = host[0].to(self.dev), host[1].to(self.dev)
        self.cache.k[:, idx] = dk
        self.cache.v[:, idx] = dv

    def _swap_index(self, pids: List[int]) -> np.ndarray:
        """Swap gather/scatter page index, padded to a power-of-two width
        with the scratch page."""
        out = np.full((_bucket(len(pids), lo=2),), self.scratch, np.int32)
        out[:len(pids)] = pids
        return out

    def apply_cow(self, copies) -> None:
        """Mirror the tick's copy-on-write events as device page copies, in
        log order (a later copy may source a page an earlier one freed)."""
        for _sid, src, dst in copies:
            self._copy_fn(self.binding.page_of(src),
                          self.binding.page_of(dst))

    # --- compute ----------------------------------------------------------
    def _account_prefill(self, Np: int, C: int) -> None:
        """Analytic HBM bytes of one chunk: the gather path pays 3x the
        gathered view plus ~3x the chunk, the in-place path the view once
        plus the chunk scatter (same model as the JAX backend)."""
        tok_bytes = self.kv_bytes_per_token()
        st = self.b.dispatch_stats
        st["prefill_gather_bytes"] += (3 * Np * self.page + 3 * C) * tok_bytes
        st["prefill_inplace_bytes"] += (Np * self.page + C) * tok_bytes

    def prefill(self, s: Session, chunk: int, lease) -> None:
        b, page = self.b, self.page
        ids = b._context_ids(s)
        start = s.resident_len
        segment = ids[start:start + chunk]
        C = _bucket(len(segment))
        # the table must cover the lease and end in a scratch page (the
        # padded lanes' parking position)
        n_need = max(len(lease), -(-(start + C) // page)) + 1
        Np = _bucket(n_need, lo=2)
        table = self.binding.table(lease, width=Np)
        toks = np.zeros((1, C), np.int32)
        toks[0, :len(segment)] = segment
        pos = np.full((C,), Np * page - 1, np.int32)
        pos[:len(segment)] = np.arange(start, start + len(segment))
        wpid = np.full((C,), self.scratch, np.int32)
        woff = np.zeros((C,), np.int32)
        for i in range(len(segment)):
            wpid[i] = self.binding.page_of(lease[(start + i) // page])
            woff[i] = (start + i) % page
        nxt = self._prefill_fn(toks, pos[None], table, wpid, woff,
                               start + len(segment), len(segment) - 1)
        s.meta["next_token"] = int(nxt)
        self._account_prefill(Np, C)

    def decodes(self, decodes, leases) -> None:
        page = self.page
        live = [(s, leases[s.sid], g) for s, g in decodes]
        B = _bucket(len(live), lo=1)
        maxp = _bucket(max(len(l) for _, l, _ in live), lo=1)
        tables = np.full((B, maxp), self.scratch, np.int32)
        for i, (_s, lease, _g) in enumerate(live):
            tables[i, :len(lease)] = [self.binding.page_of(x) for x in lease]
        g_max = max(g for _, _, g in live)
        ttables = self._t(tables)
        for step in range(g_max):
            toks = np.zeros((B,), np.int32)
            pos = np.zeros((B,), np.int32)
            lens = np.ones((B,), np.int32)
            wpid = np.full((B,), self.scratch, np.int32)
            woff = np.zeros((B,), np.int32)
            active: List[Tuple[Session, int]] = []
            for i, (s, lease, g) in enumerate(live):
                if step >= g:
                    continue
                p = s.resident_len + step
                toks[i] = s.meta.get("next_token", 1)
                pos[i] = p
                lens[i] = p + 1
                wpid[i] = self.binding.page_of(lease[p // page])
                woff[i] = p % page
                active.append((s, i))
            if not active:
                break
            nxt = self._decode_fn(toks, pos, ttables, lens, wpid,
                                  woff).cpu().numpy()
            for s, i in active:
                tok = int(nxt[i])
                s.meta.setdefault("generated", []).append(tok)
                s.meta["next_token"] = tok
                s.meta.setdefault("context_ids", []).append(tok)

    # --- fused mixed iteration --------------------------------------------
    def run_mixed(self, work: BatchWork) -> None:
        """One iteration-level tick as ONE ``lm_mixed_paged`` call: every
        prefill chunk becomes a pack and every decode lane advances one
        token. Pack shape (C, Np), lane count B and pack count P are
        bucketed to powers of two; slack packs/lanes park on the scratch
        page (the construction ``calibrate`` warms). Spans (``obs.spans``):
        ``run_mixed.inputs``, ``.forward`` (the enqueue alone),
        ``.readback`` and ``.commit``, in that order."""
        with spans.span("run_mixed"):
            with spans.span("run_mixed.inputs"):
                packs, decodes, C, Np, args = self._mixed_inputs(work)
            P, B = len(args[0]), len(args[7])       # p_toks, d_toks
            spans.count("pack_tokens_real",
                        sum(len(seg) for _, seg, _, _ in packs))
            spans.count("pack_tokens_computed", P * C)
            spans.count("lanes_real", len(decodes))
            spans.count("lanes_computed", B)
            with spans.span("run_mixed.forward"):
                p_next, d_next, self.cache = lm_mixed_paged(
                    self.b.cfg, self.b.params, self.cache, *args)
            with spans.span("run_mixed.readback"):
                if packs:
                    p_next = p_next.cpu().numpy()
                if decodes:
                    d_next = d_next.cpu().numpy()
                spans.count("readbacks", bool(packs) + bool(decodes))
            with spans.span("run_mixed.commit"):
                for j, (s, _seg, _start, _lease) in enumerate(packs):
                    s.meta["next_token"] = int(p_next[j])
                for i, (s, _lease) in enumerate(decodes):
                    tok = int(d_next[i])
                    s.meta.setdefault("generated", []).append(tok)
                    s.meta["next_token"] = tok
                    s.meta.setdefault("context_ids", []).append(tok)
                for _ in packs:
                    self._account_prefill(Np, C)

    def _mixed_inputs(self, work: BatchWork):
        """``run_mixed``'s packs ``(s, seg, start, lease)``, lanes
        ``(s, lease)``, C, Np and the 13 ``lm_mixed_paged`` arrays on the
        device."""
        b, page = self.b, self.page
        leases = work.leases
        packs = []
        for s, chunk in work.prefills:
            with spans.span("context_ids"):
                ids = b._context_ids(s)
            start = s.resident_len
            packs.append((s, ids[start:start + chunk], start,
                          leases.get(s.sid, ())))
        if any(g != 1 for _, g in work.decodes):
            raise ValueError("mixed tick: decode lanes carry exactly one "
                             "token")
        decodes = [(s, leases[s.sid]) for s, _g in work.decodes]

        C = _bucket(max((len(seg) for _, seg, _, _ in packs), default=1))
        n_need = 2
        for _, seg, start, lease in packs:
            n_need = max(n_need,
                         max(len(lease), -(-(start + C) // page)) + 1)
        Np = _bucket(n_need, lo=2)
        P = _bucket(len(packs), lo=1) if packs else 0
        # slack packs mirror the calibrate construction: all-scratch table,
        # full-C scratch write, kv_len C (garbage in, garbage discarded)
        p_toks = np.zeros((P, 1, C), np.int32)
        p_pos = np.full((P, 1, C), Np * page - 1, np.int32)
        p_tables = np.full((P, Np), self.scratch, np.int32)
        p_wpid = np.full((P, C), self.scratch, np.int32)
        p_woff = np.tile(np.arange(C, dtype=np.int32) % page, (P, 1))
        p_kvlen = np.full((P,), C, np.int32)
        p_last = np.full((P,), C - 1, np.int32)
        for j, (s, seg, start, lease) in enumerate(packs):
            p_toks[j, 0, :len(seg)] = seg
            p_pos[j, 0, :len(seg)] = np.arange(start, start + len(seg))
            p_tables[j] = self.binding.table(lease, width=Np)
            p_woff[j] = 0
            for i in range(len(seg)):
                p_wpid[j, i] = self.binding.page_of(lease[(start + i) // page])
                p_woff[j, i] = (start + i) % page
            p_kvlen[j] = start + len(seg)
            p_last[j] = len(seg) - 1

        B = _bucket(len(decodes), lo=1) if decodes else 0
        maxp = _bucket(max((len(l) for _, l in decodes), default=1), lo=1)
        d_toks = np.zeros((B,), np.int32)
        d_pos = np.zeros((B,), np.int32)
        d_tables = np.full((B, maxp), self.scratch, np.int32)
        d_lens = np.ones((B,), np.int32)
        d_wpid = np.full((B,), self.scratch, np.int32)
        d_woff = np.zeros((B,), np.int32)
        for i, (s, lease) in enumerate(decodes):
            p = s.resident_len
            d_tables[i, :len(lease)] = [self.binding.page_of(x)
                                        for x in lease]
            d_toks[i] = s.meta.get("next_token", 1)
            d_pos[i] = p
            d_lens[i] = p + 1
            d_wpid[i] = self.binding.page_of(lease[p // page])
            d_woff[i] = p % page

        args = [self._t(a) for a in (
            p_toks, p_pos, p_tables, p_wpid, p_woff, p_kvlen, p_last,
            d_toks, d_pos, d_tables, d_lens, d_wpid, d_woff)]
        return packs, decodes, C, Np, args


class _DenseLayout:
    """Slot-dense layout: R fixed slots of ``max_len`` dense tokens.

    Position ``max_len - 1`` of every slot is scratch: padded prefill lanes
    and idle decode lanes park their writes there, so sessions may use at
    most ``max_len - 1`` tokens. Host offload copies whole slots (no block
    granularity), synchronously; there is no swap stream."""

    stream = None

    def __init__(self, backend: TorchBackend):
        self.b = backend
        self.dev = backend.device
        self.cache = KVCache.zeros(backend.cfg, backend.max_slots,
                                   backend.max_len, backend.dtype, self.dev)
        self._slots: Dict[int, int] = {}          # sid -> slot
        self._free_slots = list(range(backend.max_slots))
        self._host_kv: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    # --- the compute calls ------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def _decode_fn(self, tokens, positions) -> torch.Tensor:
        b = self.b
        logits, self.cache = lm_decode(b.cfg, b.params, self.cache,
                                       self._t(tokens), self._t(positions))
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _prefill_fn(self, tokens, slot: int, start: int,
                    n_real: int) -> torch.Tensor:
        """Single-slot chunked prefill: a (1, C) step on a view of the
        slot's cache region, written in place. tokens: (1, C), the first
        ``n_real`` real from position ``start``; ``lm_step`` parks the
        padded lanes at the scratch position."""
        b = self.b
        sub = KVCache(self.cache.k[:, slot:slot + 1],
                      self.cache.v[:, slot:slot + 1])
        logits, _ = lm_step(b.cfg, b.params, sub, self._t(tokens),
                            q_offset=start, n_real=n_real)
        return torch.argmax(logits[0, n_real - 1], dim=-1).to(torch.int32)

    # --- binding / oracle -------------------------------------------------
    def bind_kv_pool(self, pool) -> None:
        pass                  # slots are placed here, not by block ids

    def kv_bytes_per_token(self) -> float:
        k = self.cache.k     # (L, R, T, Hkv, D): bytes/token = all-but-R,T
        per_tok = 2 * k.numel() // (k.shape[1] * k.shape[2]) * k.element_size()
        return float(per_tok)

    def calibrate(self) -> None:
        """Time one 64-token prefill chunk (slot 0, positions 0..63), one
        decode step over every slot (parked at the scratch position) and
        one slot round trip, synchronising the card inside each timed
        region."""
        b = self.b
        toks = np.zeros((1, 64), np.int32)

        def pf():
            int(self._prefill_fn(toks, 0, 0, 64))

        b._prefill_s_per_tok = b._time_once(pf) / 64
        tok1 = np.zeros((b.max_slots,), np.int32)
        pos1 = np.full((b.max_slots,), b.max_len - 1, np.int32)

        def df():
            self._decode_fn(tok1, pos1).cpu()

        b._decode_s_per_step = b._time_once(df)
        slot_bytes = 2 * self.cache.k[:, 0].numel() * \
            self.cache.k.element_size()

        def xfer():
            host = (self.cache.k[:, 0].to("cpu", copy=True),
                    self.cache.v[:, 0].to("cpu", copy=True))
            host[0].to(self.dev)
            host[1].to(self.dev)
            b._sync()

        b._h2d_bw = max(1e6, 2 * slot_bytes / b._time_once(xfer))

    # --- slots ------------------------------------------------------------
    def _slot_of(self, sid: int) -> int:
        if sid not in self._slots:
            if not self._free_slots:
                raise RuntimeError("dense layout out of slots")
            self._slots[sid] = self._free_slots.pop()
        return self._slots[sid]

    def release_session(self, sid: int) -> None:
        slot = self._slots.pop(sid, None)
        if slot is not None:
            self._free_slots.append(slot)

    def drop_host(self, sid: int) -> None:
        self._host_kv.pop(sid, None)

    def close(self) -> None:
        pass

    # --- whole-slot host offload ------------------------------------------
    def swap_out(self, s: Session) -> None:
        slot = self._slots.get(s.sid)
        if slot is None:
            return None
        # a copy even on the CPU device, where .cpu() would alias the slot
        self._host_kv[s.sid] = (self.cache.k[:, slot].to("cpu", copy=True),
                                self.cache.v[:, slot].to("cpu", copy=True))
        self.release_session(s.sid)
        return None

    def swap_in(self, s: Session, lease) -> None:
        host = self._host_kv.pop(s.sid, None)
        if host is None:
            return
        slot = self._slot_of(s.sid)
        self.cache.k[:, slot] = host[0]
        self.cache.v[:, slot] = host[1]

    def prefetch_swap_in(self, sid: int) -> Optional[TransferFuture]:
        return None

    def spill_host(self, sid: int) -> Optional[TransferFuture]:
        return None           # no NVMe data plane: the tier is modeled

    def fill_host(self, sid: int) -> Optional[TransferFuture]:
        return None

    def apply_cow(self, copies) -> None:
        pass                  # no physical sharing: nothing aliases a slot

    # --- compute ----------------------------------------------------------
    def prefill(self, s: Session, chunk: int, lease) -> None:
        b = self.b
        slot = self._slot_of(s.sid)
        ids = b._context_ids(s)
        start = s.resident_len
        segment = ids[start:start + chunk]
        bk = _bucket(len(segment))
        toks = np.zeros((1, bk), np.int32)
        toks[0, :len(segment)] = segment
        nxt = self._prefill_fn(toks, slot, start, len(segment))
        s.meta["next_token"] = int(nxt)

    def decodes(self, decodes, leases) -> None:
        b = self.b
        g_max = max(g for _, g in decodes)
        scratch = b.max_len - 1
        for step in range(g_max):
            toks = np.zeros((b.max_slots,), np.int32)
            pos = np.full((b.max_slots,), scratch, np.int32)
            live = []
            for s, g in decodes:
                if step >= g:
                    continue
                slot = self._slot_of(s.sid)
                toks[slot] = s.meta.get("next_token", 1)
                pos[slot] = s.resident_len + step
                live.append((s, slot))
            if not live:
                break
            nxt = self._decode_fn(toks, pos).cpu().numpy()
            for s, slot in live:
                tok = int(nxt[slot])
                s.meta.setdefault("generated", []).append(tok)
                s.meta["next_token"] = tok
                s.meta.setdefault("context_ids", []).append(tok)
