"""preprocess_span_s (s): the mean per input of the program's
``clean_preprocess`` spans (``ops/preprocess.preprocess``, either route)."""

from bench_port import spans


def read(ctx):
    return spans.mean_per_input(ctx.trace, "clean_preprocess")
