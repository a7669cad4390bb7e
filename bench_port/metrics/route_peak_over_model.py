"""route_peak_over_model (%): the device-memory high-water mark that the
program records for the in-memory route it cleaned on (the gauge
``route_hbm_peak_bytes{route}`` of ``obs/memory.observe_route``, set when
``core/cleaner.clean_cube`` finishes a route) over the working set that its
router budgets for that route at the cell's shape
(``parallel/autoshard.clean_working_set_bytes``).  Under 100 the route holds
less than the router plans for; over 100 it holds more.  Nothing to read
where the timed path records no such route (the threshold sweep), or where
the clean went another way (chunked, sharded)."""


def read(ctx):
    from iterative_cleaner_tpu_torch.obs import tracing
    from iterative_cleaner_tpu_torch.ops.fused_kernels import resolve_use_kernel
    from iterative_cleaner_tpu_torch.parallel.autoshard import clean_working_set_bytes

    entry = ctx.entry
    route = "fused" if entry.cfg.fused else "stepwise"
    _flat, labeled = tracing.gauges_snapshot()
    peak = labeled.get(("route_hbm_peak_bytes", (("route", route),)))
    if not peak:
        return None
    use_kernel = resolve_use_kernel(entry.cfg, entry.shape[-1], entry.device)
    return 100.0 * peak / clean_working_set_bytes(entry.shape, entry.cfg, use_kernel)
