"""warmup_wait_s (s): the mean per input of the program's
``clean_warmup_wait`` spans, the main thread's join of the warm-up thread
in ``models/surgical.SurgicalCleaner.clean``: how long the warm-up outlasts
preprocessing."""

from bench_port import spans


def read(ctx):
    return spans.mean_per_input(ctx.trace, "clean_warmup_wait")
