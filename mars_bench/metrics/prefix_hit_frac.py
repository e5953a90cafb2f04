"""Share of round-0 prompt tokens attached from the radix prefix cache:
PREFIX_HIT tokens inside the window over the round-0 prompt tokens of
the sessions admitted inside it (both counted at admission)."""
from mars_bench.window import GPU_SUBMIT, PREFIX_HIT


def read(run):
    admitted = {e.sid for e in run.of(GPU_SUBMIT)
                if e.data.get("round") == 0 and run.inside(e.t)}
    prompt = sum(run.rounds[sid][0][0] for sid in admitted)
    hit = sum(int(e.data["tokens"]) for e in run.of(PREFIX_HIT)
              if run.inside(e.t))
    return (hit / prompt, prompt) if prompt else None
