"""MLA prefill attention's share of its roofline, in %: the least time of
every profiled pack's causal attention over its latent pages (per layer:
``roofline.prefill_attn_work``, the published attention) over the device
time of the kernel records named in KERNELS (``paged_mla_prefill``). A
kernel that runs the absorbed form does 3.4 times the counted operations
at kanana's widths, and reads low by as much."""
from mars_bench import roofline
from mars_bench.trace import kernel_seconds

KERNELS = ("paged_mla_prefill_kernel",)


def read(run):
    if run.profile is None:
        return None
    least, n = 0.0, 0
    L = run.cfg["num_hidden_layers"]
    for it in run.iters:
        if it.profiled:
            for _sid, start, k, _C in it.packs:
                w = roofline.prefill_attn_work(run.cfg, start, k)
                least += L * roofline.least_s(*w)
                n += L
    dev = kernel_seconds(run.profile, KERNELS)
    return (100.0 * least / dev, n) if least and dev else None
