"""External Control Plane (paper §4.2, Algorithm 1).

Global Load Balancer  — ``pack_queue``: pressure-aware admission ordering
    * normal        -> ascending by estimated KV blocks (favor interactive)
    * CPU overload  -> descending (favor GPU-heavy, throttle new tool work)
    * all-long queue-> first-fit under the available KV budget
External Admission Controller — ``update_window``: AIMD window W_adm with
hysteresis (in Telemetry), clamped by CPU- and KV-derived limits.
``balance_and_admit`` composes both into one control step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from repro_torch.core import events as ev
from repro_torch.core.events import EventBus
from repro_torch.core.session import Session
from repro_torch.core.telemetry import Telemetry


@dataclass
class ControlPlaneConfig:
    w_init: float = 8.0
    w_min: float = 1.0
    w_max: float = 512.0
    additive_alpha: float = 1.0        # const alpha > 0   (Alg.1 l.17)
    multiplicative_beta: float = 0.7   # const beta < 1    (Alg.1 l.15)
    control_interval: float = 2.0      # seconds between AIMD updates
    long_session_blocks: int = 1024    # "long" threshold for first-fit mode
    block_size: int = 32
    # CPU-oversubscription admission term: defer an admit whose tool
    # profile (per-kind EMA CPU seconds) would push the shared core pool's
    # projected queueing delay past this bound — the CPU analogue of the
    # KV-blocks sizing above. inf disables the term (CPU-naive admission).
    cpu_queue_bound_s: float = float("inf")


class ExternalControlPlane:
    def __init__(self, cfg: ControlPlaneConfig, telem: Telemetry, bus: EventBus):
        self.cfg = cfg
        self.telem = telem
        self.bus = bus
        self.w_adm = cfg.w_init
        self._last_update = -1e18
        # radix-aware admission: session -> blocks of its chunk-key prefix
        # already indexed on this replica (exact ``RadixIndex.match`` when
        # bound in-process by the engine; a remote control plane can bind
        # ``kvcache.radix.estimate_digest_match`` over the heartbeat digest)
        self.prefix_lookup = None
        # shared host-CPU core pool (bound via Services when the engine has
        # one): its work-in-system horizon is the pressure signal the
        # cpu_queue_bound_s term prices. None => term inactive.
        self.cpu_pool = None
        self.cpu_deferred = 0          # admits deferred on projected CPU wait
        # standing per-round tool-CPU commitments of admitted, unfinished
        # sessions. The pool's instantaneous schedule lags admission by a
        # whole prefill phase (a session puts nothing on cores until its
        # first tool), so the projection must count admitted demand that
        # has not reached the pool yet or every arrival wave sails in
        # before the cores heat up.
        self._cpu_commit: Dict[int, float] = {}
        bus.subscribe(ev.FINISH, self._on_finish)

    def _on_finish(self, e) -> None:
        self._cpu_commit.pop(e.sid, None)

    # --- helpers -------------------------------------------------------------
    def estimate_blocks(self, s: Session) -> int:
        """Lightweight per-session KV-block estimate from prefill length
        (proxy for both compute demand and spatial footprint), minus the
        shared prefix this replica's radix index already holds — a family
        member attaching to an existing repository context neither computes
        nor (physically) allocates those blocks, so under pressure it may
        admit earlier than its raw prompt size suggests. Never estimates
        below one chunk: even a full-duplicate session recomputes/holds at
        least its tail block."""
        est = -(-s.pending_prefill // self.cfg.block_size)
        if self.prefix_lookup is not None:
            est -= max(0, int(self.prefix_lookup(s)))
        return max(1, est)

    def estimate_tool_cpu(self, s: Session) -> float:
        """Per-session tool CPU profile: mean EMA-estimated seconds over
        the session's tool-bearing rounds — what one admitted session is
        expected to put on the shared core pool per tool yield. 0.0 for
        tool-free sessions (they never contend for cores)."""
        ests = [self.telem.tool_estimate(r.tool_kind)
                for r in s.rounds if r.tool_kind is not None]
        return (sum(ests) / len(ests)) if ests else 0.0

    # --- Alg.1 PackQueue ------------------------------------------------------
    def pack_queue(self, queue: List[Session]) -> List[Session]:
        t = self.telem
        est = {s.sid: self.estimate_blocks(s) for s in queue}
        if not queue:
            return queue
        if t.cpu_overloaded:
            return sorted(queue, key=lambda s: -est[s.sid])
        if all(e >= self.cfg.long_session_blocks for e in est.values()):
            return self._first_fit(queue, est, t.free_blocks)
        return sorted(queue, key=lambda s: est[s.sid])

    @staticmethod
    def _first_fit(queue: List[Session], est, available: int) -> List[Session]:
        """Assemble a feasible admission set under the current KV budget,
        then append the rest (largest-last) — oversized heads no longer block
        admissible sessions behind them."""
        fits, rest, budget = [], [], available
        for s in sorted(queue, key=lambda s: est[s.sid]):
            if est[s.sid] <= budget:
                fits.append(s)
                budget -= est[s.sid]
            else:
                rest.append(s)
        return fits + rest

    # --- Alg.1 UpdateWindow ---------------------------------------------------
    def update_window(self, now: float, avg_blocks_per_session: float) -> int:
        c, t = self.cfg, self.telem
        w_cpu = t.calc_cpu_limit()
        w_kv = t.calc_kv_limit(avg_blocks_per_session)
        if now - self._last_update >= c.control_interval:
            if t.cpu_overloaded or t.kv_overloaded:
                self.w_adm = max(c.w_min, self.w_adm * c.multiplicative_beta)
            elif not t.cpu_overloaded and t.has_kv_slack():
                self.w_adm = min(c.w_max, self.w_adm + c.additive_alpha)
            self._last_update = now
            self.bus.emit(ev.WINDOW_UPDATE, now, w_adm=self.w_adm,
                          w_cpu=w_cpu, w_kv=w_kv,
                          cpu_overloaded=t.cpu_overloaded,
                          kv_overloaded=t.kv_overloaded)
        return int(min(self.w_adm, w_cpu, w_kv))

    # --- Alg.1 BalanceAndAdmit -------------------------------------------------
    def balance_and_admit(self, queue: List[Session], now: float) -> List[Session]:
        if not queue:
            return []
        ordered = self.pack_queue(queue)
        avg_blocks = (sum(self.estimate_blocks(s) for s in queue) / len(queue))
        limit = self.update_window(now, avg_blocks)
        slots = limit - self.telem.active_sessions
        if slots <= 0:
            return []
        # CPU-oversubscription term: walk the packed order keeping a
        # running backlog of the tool CPU this cycle's admits would add;
        # defer (skip, not reject) any session whose profile would push
        # the pool's projected core-queueing delay past the bound —
        # tool-light sessions behind it still pass.
        bound = self.cfg.cpu_queue_bound_s
        price_cpu = bound != float("inf") and self.cpu_pool is not None
        admitted: List[Session] = []
        # hypothetical backlog this cycle's admits stack on top of the
        # standing commitments of every admitted-but-unfinished session
        extra_cpu_s = sum(self._cpu_commit.values()) if price_cpu else 0.0
        for s in ordered:
            if len(admitted) >= slots:
                break
            if price_cpu:
                est = self.estimate_tool_cpu(s)
                if est > 0.0:
                    # the candidate waits behind scheduled + committed
                    # work and this cycle's earlier admits — never behind
                    # itself (else a session with est > bound*cores
                    # starves on an idle pool); its own est joins the
                    # backlog only once it passes, pricing the admits
                    # after it
                    wait = max(self.cpu_pool.horizon_wait(now),
                               extra_cpu_s / self.cpu_pool.cores)
                    if wait > bound:
                        self.cpu_deferred += 1
                        continue
                    extra_cpu_s += est
                    self._cpu_commit[s.sid] = est
            admitted.append(s)
        for s in admitted:
            self.bus.emit(ev.ADMIT, now, s.sid,
                          est_blocks=self.estimate_blocks(s))
        return admitted
