"""parity_scan_s (s): the mean per input of the program's
``clean_parity_scan`` spans, the magnitude scan of the host cube in
``core/cleaner._parity_warnings`` (two host passes; only below its size
cap, so nothing to read where ``clean_cube`` does not scan)."""

from bench_port import spans


def read(ctx):
    return spans.mean_per_input(ctx.trace, "clean_parity_scan")
