"""loop_idle_share (%): the share of the program's ``clean_loop`` spans
(main thread) in which no kernel, copy or memset ran on the card: how much
of the convergence loop the card waits on the host."""

from bench_port import spans


def read(ctx):
    t = ctx.trace
    loops = spans.spans(t, "clean_loop")
    total = sum(e.dur for e in loops)
    if total <= 0 or not t.device:
        return None
    busy = sum(spans.busy_within(t, e.start, e.end) for e in loops)
    return 100.0 * (1.0 - busy / total)
