"""Agent session / round state machine.

A *session* is the serving-layer view of one agentic task: a sequence of
rounds, each ``LLM call (prefill of appended context + decode) -> tool
execution``, sharing one logical context whose KV is the suspended state the
scheduler manages (paper §2.2 "temporal shift").
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class Phase(enum.Enum):
    WAITING_ADMIT = "waiting_admit"   # in external queue, not yet admitted
    READY_PREFILL = "ready_prefill"   # admitted, needs (more) prefill
    DECODING = "decoding"
    TOOL = "tool"                     # yielded to host-side tool execution
    FINISHED = "finished"


class KVState(enum.Enum):
    NONE = "none"            # no resident KV (cold)
    RESIDENT = "resident"    # KV resident, session active on GPU
    PINNED = "pinned"        # KV retained across a tool phase
    SWAPPED = "swapped"      # KV in host DRAM (legacy swap or host tier)


class KVAction(enum.Enum):
    """Retention outcome at a tool boundary (four-way under MARS)."""
    FREE = "free"            # drop: rebuild by prefix recompute on resume
    PIN = "pin"              # retain in HBM across the tool phase
    SWAP = "swap"            # legacy host swap (InferCept's stock-vLLM path)
    OFFLOAD = "offload"      # tiered host-DRAM offload (kvcache.host_tier)
    OFFLOAD_DISK = "offload_disk"  # cold NVMe tier (kvcache.disk_tier),
    #                                staged two-hop restore via host DRAM


@dataclass
class Round:
    new_input_tokens: int            # context appended before this LLM call
    decode_tokens: int               # output tokens this call produces
    tool_kind: Optional[str] = None  # None for the final round
    tool_seconds: float = 0.0        # ground-truth duration (sim / synthetic)


_session_counter = itertools.count()


@dataclass
class Session:
    sid: int
    arrival_time: float
    rounds: List[Round]
    slo_alpha: float = 3.0
    ideal_time: float = 0.0          # isolated execution time (for goodput)

    # --- live state --------------------------------------------------------
    phase: Phase = Phase.WAITING_ADMIT
    cur_round: int = 0
    context_len: int = 0             # logical tokens accumulated so far
    resident_len: int = 0            # tokens with KV currently resident
    prefill_done: int = 0            # tokens of current round's target prefilled
    decoded: int = 0                 # tokens decoded in current round
    kv_state: KVState = KVState.NONE
    kv_blocks: int = 0               # blocks currently held
    pinned_since: float = 0.0
    pin_ttl: float = 0.0             # Continuum-style TTL (0 = policy default)
    tool_started: float = 0.0
    tool_deadline: float = 0.0

    # --- accounting ---------------------------------------------------------
    service_seconds: float = 0.0     # accumulated GPU service (PLAS/MLFQ)
    service_tokens: int = 0
    last_service: float = 0.0
    admitted_at: float = -1.0
    round_submit: float = 0.0        # gpu_submit of current round
    ttfts: List[float] = field(default_factory=list)
    first_token_seen: bool = False
    finish_time: float = -1.0
    preemptions: int = 0
    recomputed_tokens: int = 0
    swap_in_pending: float = 0.0     # seconds of swap-in left before resume
    meta: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def cur(self) -> Round:
        return self.rounds[self.cur_round]

    @property
    def total_prompt_tokens(self) -> int:
        return sum(r.new_input_tokens for r in self.rounds)

    @property
    def prefill_target(self) -> int:
        """Tokens that must be resident before this round can decode."""
        return self.context_len_at_round_start() + self.cur.new_input_tokens

    def context_len_at_round_start(self) -> int:
        return sum(r.new_input_tokens + r.decode_tokens
                   for r in self.rounds[: self.cur_round])

    @property
    def pending_prefill(self) -> int:
        """Tokens still to prefill now (includes rebuild after eviction)."""
        return max(0, self.prefill_target - self.resident_len)

    @property
    def e2e_latency(self) -> float:
        assert self.finish_time >= 0
        return self.finish_time - self.arrival_time

    @property
    def slo_met(self) -> bool:
        return self.e2e_latency <= self.slo_alpha * self.ideal_time

    def is_long(self, long_threshold_tokens: int) -> bool:
        return self.pending_prefill >= long_threshold_tokens

    def __hash__(self):
        return self.sid

    def __repr__(self):
        return (f"Session({self.sid}, {self.phase.value}, r{self.cur_round}/"
                f"{len(self.rounds)}, ctx={self.context_len}, kv={self.kv_state.value})")


def make_session(arrival_time: float, rounds: List[Round], *, slo_alpha: float = 3.0,
                 ideal_time: float = 0.0, sid: Optional[int] = None) -> Session:
    return Session(sid=next(_session_counter) if sid is None else sid,
                   arrival_time=arrival_time, rounds=rounds,
                   slo_alpha=slo_alpha, ideal_time=ideal_time)
