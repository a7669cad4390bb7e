"""ordered_template_roofline (%): the least time of one launch at the
cell's shape (``bounds.template_cost``; the threshold sweep's pairs read
their one cube once) over the mean device time of the kernel's records."""

from bench_port import bounds

KERNEL = "ordered_template"


def read(ctx):
    recs = ctx.trace.kernels(f"{KERNEL}_kernel")
    launch = ctx.kernels.get(KERNEL)
    if not recs or launch is None:
        return None
    mean_s = sum(e.dur for e in recs) / len(recs)
    return 100.0 * bounds.bound_s(KERNEL, **launch) / mean_s
