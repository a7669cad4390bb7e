"""batch_preprocess_s (s): the mean per input of the program's
``clean_batch_preprocess`` spans, the calling thread's wait while the
directory batch preprocesses one call's archives on its small pool
(``parallel/batch.clean_archives``); nothing to read where the program has
no such span."""

from bench_port import spans


def read(ctx):
    return spans.mean_per_input(ctx.trace, "clean_batch_preprocess")
