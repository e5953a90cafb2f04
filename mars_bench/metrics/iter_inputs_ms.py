"""Mean wall, in ms, of the program's ``run_mixed.inputs`` span in the
window's mixed iterations (those the profiler covered): the pack and lane
arrays built on the host, the sessions' contexts synthesised
(``context_ids``) and the 13 host-to-device copies."""
from mars_bench import program_spans as P


def read(run):
    ms, n, got = P.phase_ms(run, "run_mixed.inputs")
    if not n:
        return None
    sp = P.spans_of(run)
    kids = P.children(sp)
    total = sum(sp[j].dur for j in got)
    ctx = [c for j in got for c in kids.get(j, ())
           if sp[c].name == "context_ids"]
    return (ms, n, {
        "max_ms": 1e3 * max(sp[j].dur for j in got),
        "context_ids_share": sum(sp[c].dur for c in ctx) / total
        if total > 0 else 0.0,
        "context_tokens_synthesized": sum(
            sp[c].counts.get("context_tokens_synthesized", 0) for c in ctx)})
