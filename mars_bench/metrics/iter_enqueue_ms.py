"""Mean wall, in ms, of the program's ``run_mixed.forward`` span in the
window's mixed iterations (those the profiler covered): the host enqueuing
``lm_mixed_paged``'s launches. Beside it, the mean self time per iteration
of each span under it (``step.pack``, ``step.decode``, ``layer.attn``,
``layer.ffn``, ``moe.*``), in ms, and the spans the program dropped for
want of room (none should be)."""
from mars_bench import program_spans as P


def read(run):
    ms, n, got = P.phase_ms(run, "run_mixed.forward")
    if not n:
        return None
    sp = P.spans_of(run)
    kids = P.children(sp)
    self_ms = {}
    for j in got:
        for name, s in P.self_s(sp, kids, j).items():
            self_ms[name] = self_ms.get(name, 0.0) + 1e3 * s / n
    return (ms, n, {"self_ms": dict(sorted(self_ms.items())),
                    "spans_dropped": P.dropped(run)})
