"""MLA decode attention's share of its roofline, in %: the least time of
every profiled decode launch (per layer, all its lanes:
``roofline.decode_attn_work``, the published attention) over the device
time of the kernel records named in KERNELS (``paged_mla_decode``: its
split and combine kernels)."""
from mars_bench import roofline
from mars_bench.trace import kernel_seconds

KERNELS = ("paged_mla_decode_split", "paged_mla_decode_combine")


def read(run):
    if run.profile is None:
        return None
    least, n = 0.0, 0
    L = run.cfg["num_hidden_layers"]
    for it in run.iters:
        if it.profiled and it.lanes:
            w = roofline.decode_attn_work(run.cfg,
                                          [pos + 1 for _s, pos in it.lanes])
            least += L * roofline.least_s(*w)
            n += L
    dev = kernel_seconds(run.profile, KERNELS)
    return (100.0 * least / dev, n) if least and dev else None
