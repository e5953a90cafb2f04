"""What the timed path produced, and its comparison with the reference.

``Writes`` keeps, per session, what each call of the mixed iteration fed
at each position and what it served: the decode lanes' tokens, and the
greedy token a round's last prefill pack hands to its first lane. Once
the window has closed, ``compare`` runs the plain reference
(``reference.py``) over the fed streams of a sample of sessions drawn
from the seed, with the longest stream always in it, and measures how far
below the reference's best each served token's logit lies, in standard
deviations of that position's logits. The widest gap is the number held
against the configuration's limit.

A call that rewrites positions already fed (a recompute after a drop or
a preemption) starts a new epoch, so every served token is compared with
the context it was served from. Positions attached from the radix prefix
cache are fed with the round-0 content the session would have computed
itself; the reference computes them again, so the shared pages, and the
copy-on-write tails written after them, are checked through every token
served on top of them. Pages carried across a tool pause (pinned,
offloaded and restored) are checked the same way.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from mars_bench import reference


class Writes:
    """Per session: ``fed`` (token at each position) and ``ops`` in call
    order: ``("pack", start, n, C, served)`` (``served``: the greedy token
    at its last position when the pack ends a round's prompt, else None),
    ``("lane", pos, served)`` and ``("gap", a, b)`` for positions attached
    from the radix; ``round`` maps each served position to its round."""

    def __init__(self):
        self.cur: Dict[int, dict] = {}
        self.done: Dict[int, List[dict]] = {}

    def _epoch(self, s, pos: int) -> dict:
        e = self.cur.setdefault(s.sid, {"fed": [], "ops": [], "round": {}})
        if pos < len(e["fed"]):             # rewrite: a new epoch keeps the
            self.done.setdefault(s.sid, []).append(e)   # calls below pos
            ops = []
            for op in e["ops"]:
                if op[1] >= pos:
                    continue
                if op[0] == "lane":
                    ops.append(("lane", op[1], None))
                elif op[0] == "pack":
                    ops.append(("pack", op[1], min(op[2], pos - op[1]),
                                op[3], None))
                else:
                    ops.append(("gap", op[1], min(op[2], pos)))
            e = self.cur[s.sid] = {"fed": e["fed"][:pos], "ops": ops,
                                   "round": {}}
        if pos > len(e["fed"]):             # attached radix prefix
            e["ops"].append(("gap", len(e["fed"]), pos))
            e["fed"].extend(s.meta["context_ids"][len(e["fed"]):pos])
        return e

    def pack(self, s, start: int, toks: Sequence[int], C: int,
             served) -> None:
        e = self._epoch(s, start)
        e["fed"].extend(toks)
        e["ops"].append(("pack", start, len(toks), C, served))
        if served is not None:
            e["round"][start + len(toks) - 1] = s.cur_round

    def lane(self, s, pos: int, fed: int, out: int) -> None:
        e = self._epoch(s, pos)
        e["fed"].append(fed)
        e["ops"].append(("lane", pos, out))
        e["round"][pos] = s.cur_round

    def epochs(self, sid: int) -> List[dict]:
        return self.done.get(sid, []) + ([self.cur[sid]]
                                         if sid in self.cur else [])


def served(e: dict) -> Dict[int, int]:
    """Position -> the token served from it."""
    out = {}
    for op in e["ops"]:
        if op[0] == "lane" and op[2] is not None:
            out[op[1]] = op[2]
        elif op[0] == "pack" and op[4] is not None:
            out[op[1] + op[2] - 1] = op[4]
    return out


def sample(writes: Writes, seed: int, k: int) -> List[int]:
    """``k`` sessions that were served tokens: the one with the longest
    stream, then others drawn from ``seed``."""
    length = {sid: max(max(served(e), default=-1)
                       for e in writes.epochs(sid))
              for sid in set(writes.cur) | set(writes.done)}
    pool = sorted(sid for sid, n in length.items() if n >= 0)
    if not pool or k < 1:
        return []
    first = max(pool, key=lambda sid: (length[sid], -sid))
    rest = [sid for sid in pool if sid != first]
    rng = np.random.default_rng(seed)
    pick = rng.choice(rest, size=min(k - 1, len(rest)), replace=False) \
        if rest and k > 1 else []
    return [first] + sorted(int(x) for x in pick)


def compare(cfg: Dict, params: Dict, writes: Writes, sids: Sequence[int],
            *, control: bool = False) -> Dict:
    """Gaps of every token served to ``sids``. With ``control``, also the
    gaps, on the float32 reference, of the tokens the fp8 control puts
    first at the same positions. ``moe_entries`` and ``moe_dropped``: the
    routed entries of the sample's MoE layers, and those the program's
    capacity dispatch drops as the reference replays it (0 for a dense
    model)."""
    gaps, ctrl, resumed, attached = [], [], 0, 0
    tally = {"moe_entries": 0, "moe_dropped": 0}
    for sid in sids:
        for e in writes.epochs(sid):
            want = served(e)
            if not want:
                continue
            rows = sorted(want)
            toks = e["fed"][:rows[-1] + 1]
            groups = reference.stream_groups(e["ops"])
            ref = reference.forward_logits(cfg, params, toks, rows,
                                           moe_groups=groups, tally=tally)
            gaps += reference.gaps_sd(ref, [want[p] for p in rows])
            resumed += sum(e["round"].get(p, 0) > 0 for p in rows)
            attached += any(op[0] == "gap" for op in e["ops"])
            if control:
                low = reference.forward_logits(cfg, params, toks, rows,
                                               moe_groups=groups,
                                               precision="fp8")
                ctrl += reference.control_gaps_sd(ref, low)
                del low
            del ref
    out = {"sessions": list(sids), "tokens": len(gaps),
           "resumed_tokens": int(resumed), "attached_epochs": int(attached),
           **tally, **stats(gaps)}
    if control:
        out["control"] = stats(ctrl)
    return out


def passes(stats: Dict, limits: Dict, tokens: int, failed: int,
           invariants: bool) -> bool:
    """The verdict ``correct``: every limited statistic present and within
    its limit, at least one served token compared, no round failed and
    the engine's invariants whole. The program's gaps and the control's
    are judged by this one rule."""
    return (all(stats.get(n) is not None and stats[n] <= lim
                for n, lim in limits.items())
            and tokens >= 1 and failed == 0 and invariants)


def stats(gaps: Sequence[float]) -> Dict:
    """The numbers a check can compare: the widest gap, the mean gap, the
    share of served tokens that are not the reference's best, and the
    shares whose gap exceeds 0.05, 0.1 and 0.2 sd."""
    keys = ("max_gap_sd", "mean_gap_sd", "mismatch_frac",
            "over_0.05_sd_frac", "over_0.1_sd_frac", "over_0.2_sd_frac")
    if not gaps:
        return dict.fromkeys(keys)
    n = len(gaps)
    return dict(zip(keys, (max(gaps), sum(gaps) / n,
                           sum(g > 0 for g in gaps) / n,
                           sum(g > 0.05 for g in gaps) / n,
                           sum(g > 0.1 for g in gaps) / n,
                           sum(g > 0.2 for g in gaps) / n)))
