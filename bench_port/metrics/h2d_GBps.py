"""h2d_GBps (GB/s): bytes of the host-to-device copies over their summed
device time."""


def read(ctx):
    copies = [e for e in ctx.trace.copies("HtoD") if e.dur > 0]
    nbytes = sum(float(e.args.get("bytes", 0)) for e in copies)
    if not copies or nbytes <= 0:
        return None
    return nbytes / sum(e.dur for e in copies) / 1e9
