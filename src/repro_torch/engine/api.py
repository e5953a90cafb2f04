"""OpenAI-style serving front-end (paper §5 Implementation).

The paper integrates MARS by augmenting the OpenAI-compatible request schema
with stable per-session metadata (persistent ``job_id``, tool-transition
markers) propagated into the engine. This module is that layer for the live
engine: an in-process API that accepts chat-completion-shaped requests tagged
with a ``job_id``, maintains session continuity across rounds (the KV
residency decisions key off the same session), and returns futures.

    api = ServingAPI(engine)
    fut = api.submit(job_id="task-1", prompt_tokens=[...], max_tokens=32,
                     tool_call={"kind": "terminal", "fn": run_tests})
    api.pump(now);  result = fut.result()   # {'tokens': [...], 'ttft': ...}

A deployment would put this behind HTTP; the schema and session plumbing are
the substance, transport is not.
"""
from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import events as ev
from repro_torch.core.session import Phase, Round, Session, make_session
from repro_torch.engine.engine import Engine


@dataclass
class ChatRequest:
    """One LLM round of an agentic job (OpenAI-compatible shape + MARS
    session metadata extensions)."""
    job_id: str
    prompt_tokens: List[int]          # tokenized new context this round
    max_tokens: int = 64
    tool_call: Optional[Dict[str, Any]] = None   # {'kind', 'fn'|'seconds'}
    final: bool = False               # last round of the job


class ServingAPI:
    """Session-continuity front-end over a live Engine.

    Each ``job_id`` maps to one engine Session whose rounds are appended as
    requests arrive — this is what lets the scheduler treat the multi-round
    job as one stateful workflow (warm KV across rounds) instead of
    independent requests.
    """

    def __init__(self, engine: Engine):
        self.engine = engine
        self._jobs: Dict[str, Session] = {}
        self._futures: Dict[tuple, Future] = {}
        self._lock = threading.Lock()
        engine.bus.subscribe(ev.GPU_END, self._on_round_end)
        engine.bus.subscribe("reject", self._on_reject)

    # ------------------------------------------------------------------
    def submit(self, req: ChatRequest, now: float = 0.0) -> Future:
        """Queue one round; returns a Future of {'tokens', 'ttft', 'round'}."""
        with self._lock:
            fut: Future = Future()
            tool_kind = None
            tool_seconds = 0.0
            if req.tool_call is not None and not req.final:
                tool_kind = req.tool_call.get("kind", "default")
                tool_seconds = float(req.tool_call.get("seconds", 0.0))
            rnd = Round(new_input_tokens=max(1, len(req.prompt_tokens)),
                        decode_tokens=req.max_tokens,
                        tool_kind=tool_kind, tool_seconds=tool_seconds)
            s = self._jobs.get(req.job_id)
            fresh = s is None
            if fresh:
                s = make_session(now, [rnd], ideal_time=1.0)
                s.meta["job_id"] = req.job_id
                s.meta["context_ids"] = list(req.prompt_tokens)
                s.meta["tool_fns"] = {}
                self._jobs[req.job_id] = s
            else:
                # append the next round to the live session (continuity)
                assert s.phase != Phase.FINISHED, f"job {req.job_id} finished"
                s.rounds.append(rnd)
                s.meta.setdefault("context_ids", []).extend(req.prompt_tokens)
            round_idx = len(s.rounds) - 1
            if req.tool_call is not None and "fn" in req.tool_call:
                s.meta["tool_fns"][round_idx] = req.tool_call["fn"]
            # register the future before submission: capacity rejection fires
            # synchronously inside engine.submit
            self._futures[(req.job_id, round_idx)] = fut
            if fresh:
                self.engine.submit(s)
            return fut

    # ------------------------------------------------------------------
    def _on_round_end(self, e) -> None:
        s = self._sid_session(e.sid)
        if s is None:
            return
        key = (s.meta.get("job_id"), e.data.get("round"))
        fut = self._futures.pop(key, None)
        if fut is not None and not fut.done():
            gen = s.meta.get("generated", [])
            r = e.data.get("round", 0)
            n = s.rounds[r].decode_tokens
            fut.set_result({
                "job_id": key[0], "round": r,
                "tokens": gen[-n:] if gen else [],
                "ttft": s.ttfts[r] if r < len(s.ttfts) else None,
            })

    def _on_reject(self, e) -> None:
        s = self._sid_session(e.sid)
        if s is None:
            return
        for key, fut in list(self._futures.items()):
            if key[0] == s.meta.get("job_id") and not fut.done():
                fut.set_exception(RuntimeError(
                    f"job {key[0]} rejected: context exceeds KV capacity"))
                self._futures.pop(key, None)

    def _sid_session(self, sid: int) -> Optional[Session]:
        for s in self._jobs.values():
            if s.sid == sid:
                return s
        return None

    # ------------------------------------------------------------------
    def active_jobs(self) -> List[str]:
        return [j for j, s in self._jobs.items() if s.phase != Phase.FINISHED]
