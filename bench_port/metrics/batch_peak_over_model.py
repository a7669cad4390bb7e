"""batch_peak_over_model (%): the device-memory high-water mark that the
program records for the directory batch's dispatches (the gauge
``route_hbm_peak_bytes{route=sharded_batch}`` of
``obs/memory.observe_route``) over the working set that sized them
(``parallel/autoshard.batch_working_set_bytes`` of the entry's ``batch``
archives at the cell's shape, on the kernel route the batch resolves).
Under 100 a dispatch holds less than its sizing plans for; over 100 more.
Nothing to read where the program records no such route."""


def read(ctx):
    from iterative_cleaner_tpu_torch.obs import tracing
    from iterative_cleaner_tpu_torch.ops.fused_kernels import resolve_use_kernel
    from iterative_cleaner_tpu_torch.parallel.autoshard import batch_working_set_bytes

    entry = ctx.entry
    _flat, labeled = tracing.gauges_snapshot()
    peak = labeled.get(("route_hbm_peak_bytes", (("route", "sharded_batch"),)))
    if not peak:
        return None
    use_kernel = resolve_use_kernel(entry.cfg.replace(x64=False), entry.shape[-1], entry.device)
    return 100.0 * peak / batch_working_set_bytes(entry.shape, entry.cfg, use_kernel, entry.batch)
