"""Device-memory and host-RSS accounting.

The port of ``iterative_cleaner_tpu/obs/memory.py:1-206``, on
``torch.cuda.memory_stats`` / ``torch.cuda.mem_get_info``.  One module owns
every read of the card's memory (``parallel/autoshard.device_memory_bytes``
delegates here), so the routing decision and the exported gauges never
disagree about what the card reported.

Everything lands in :mod:`.tracing` gauges (``hbm_bytes_in_use{device}``,
``hbm_peak_bytes_in_use{device}``, ``hbm_bytes_limit{device}``,
``route_hbm_peak_bytes{route}``, ``host_rss_bytes``) and in the JSON
:func:`memory_report`.  The names keep the JAX package's ``hbm_`` prefix:
the card's memory is HBM too.

Strictly read-only: nothing here resets the allocator's peak
(``torch.cuda.reset_peak_memory_stats``), so a caller that measures its own
peak reads what it read before; and nothing here initialises CUDA — every
device read first checks ``torch.cuda.is_initialized()``.

The JAX package's static executable analysis (``analyze_batch_route``:
XLA's cost and memory analysis of the service's bucket executable) has no
torch counterpart.  The port's :func:`analyze_batch_route` stands in for it
with its own model: the bytes and float32 operations of one iteration of
its two hand kernels at the bucket's shape, and the peak of
``parallel/autoshard.batch_working_set_bytes``.  :func:`update_spool_gauge`
exports the serving daemon's spool headroom.
"""

from __future__ import annotations

import os
import shutil
import sys
import threading

from iterative_cleaner_tpu_torch.obs import tracing

_ENV_OVERRIDE = "ICT_HBM_BYTES"

_exec_lock = threading.Lock()
_exec_registry: dict[str, dict] = {}  # ict: guarded-by(_exec_lock)


def hbm_override_bytes() -> int | None:
    """The ``ICT_HBM_BYTES`` escape hatch (tests, and hosts where the
    runtime misreports) — honoured before any device is touched."""
    env = os.environ.get(_ENV_OVERRIDE)
    if env:
        return int(env)
    return None


def backend_live() -> bool:
    """Whether CUDA is already initialised in this process — the gate every
    device read here sits behind: observability never triggers the first
    CUDA initialisation.  A process that never imported torch has none."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def device_stats(device) -> dict | None:
    """One card's memory view: bytes in use, the allocator's peak, the
    card's capacity (``bytes_limit``, from ``mem_get_info``) and what the
    driver reports free; None off the card or before CUDA is up."""
    import torch

    device = torch.device(device)
    if device.type != "cuda" or not backend_live():
        return None
    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)  # ict: backend-init-ok(gated on backend_live() above)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(total),
        "bytes_free": int(free),
    }


def device_memory_bytes(device=None) -> int | None:
    """Memory capacity of ``device`` (autoshard's routing input): the
    ``ICT_HBM_BYTES`` override first, then the card's total from
    ``torch.cuda.mem_get_info``; None on the CPU (no limit to route by).
    Routing asks before anything else touches the card, so this read may
    be the process's first CUDA call."""
    env = hbm_override_bytes()
    if env is not None:
        return env
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(dev)[1])  # ict: backend-init-ok(routing's first CUDA read: the CLI's init_watchdog and the daemon's probe come first)


def host_rss_bytes() -> int:
    """This process's resident set, from /proc (Linux) with a getrusage
    fallback; 0 when neither works."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        # ru_maxrss is kilobytes on Linux (peak, not current).
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001 — accounting is best-effort
        return 0


def device_snapshot() -> list[dict]:
    """Per-card memory view (empty before CUDA is initialised, or on a
    host without a card)."""
    if not backend_live():
        return []
    import torch

    out = []
    for i in range(torch.cuda.device_count()):  # ict: backend-init-ok(gated on backend_live() above)
        stats = device_stats(torch.device("cuda", i))
        if stats is not None:
            out.append({"device": f"cuda:{i}", **stats})
    return out


def update_process_gauges() -> None:
    """Refresh the current/peak device-memory gauges per card and the host
    RSS gauge.  Never raises."""
    try:
        tracing.set_gauge("host_rss_bytes", float(host_rss_bytes()))
        for rec in device_snapshot():
            labels = {"device": rec["device"]}
            tracing.set_gauge_labeled("hbm_bytes_in_use", labels,
                                      float(rec["bytes_in_use"]))
            tracing.set_gauge_labeled("hbm_peak_bytes_in_use", labels,
                                      float(rec["peak_bytes_in_use"]))
            if rec["bytes_limit"]:
                tracing.set_gauge_labeled("hbm_bytes_limit", labels,
                                          float(rec["bytes_limit"]))
    except Exception:  # noqa: BLE001 — gauges are best-effort
        pass


def observe_route(route: str) -> None:
    """Record the device-memory high-water mark attributable to ``route``
    (stepwise / fused / chunked): called right after a route finishes,
    while its peak is the freshest thing in the allocator's peak.  The
    gauge keeps the max ever seen per route — peaks are ratchets — and the
    allocator's own peak is left as it is.  It reads only the allocator's
    counters (``torch.cuda.memory_stats``), never ``mem_get_info``: it runs
    on the clean's path, after every route."""
    try:
        if not backend_live():
            return
        import torch

        cards = [torch.cuda.memory_stats(i)
                 for i in range(torch.cuda.device_count())]  # ict: backend-init-ok(gated on backend_live() above)
        if not cards:
            return
        peak = max(int(s.get("allocated_bytes.all.peak", 0)) for s in cards)
        in_use = max(int(s.get("allocated_bytes.all.current", 0)) for s in cards)
        labels = {"route": route}
        tracing.max_gauge_labeled("route_hbm_peak_bytes", labels, float(peak))
        tracing.set_gauge_labeled("route_hbm_bytes_in_use", labels,
                                  float(in_use))
    except Exception:  # noqa: BLE001 — gauges are best-effort
        pass


def update_spool_gauge(spool_dir: str) -> None:
    """Export the spool volume's free bytes as the
    ``ict_spool_disk_free_bytes`` gauge (a daemon whose spool volume fills
    starts failing manifest writes).  Never raises."""
    try:
        tracing.set_gauge("spool_disk_free_bytes",
                          float(shutil.disk_usage(spool_dir or ".").free))
    except Exception:  # noqa: BLE001 — gauges are best-effort
        pass


def fit_moments_cost(narch: int, shape) -> tuple[int, int]:
    """(bytes, float32 operations) of one ``fused_fit_moments`` launch over
    ``narch`` archives of ``shape`` = (nsub, nchan, nbin), each input read
    once and each output written once: D and the centred cube (4 B per
    element each), w0 and the three maps (4 B per profile each), valid
    (1 B per profile), a template per archive, the bin scale and a <t,t>
    per archive; 12 operations per element (tp: mul, add; wr: mul, sub,
    mul, mul; sum, max, min; centre, square, add).  ``chip_smoke.py``
    holds the kernel's times against these counts."""
    nsub, nchan, nbin = (int(v) for v in shape)
    n, p = narch * nsub * nchan * nbin, narch * nsub * nchan
    return 8 * n + 16 * p + p + 4 * narch * nbin + 4 * nbin + 4 * narch, 12 * n


def template_cost(shape, narch: int = 1, reads: int | None = None) -> tuple[int, int]:
    """(bytes, float32 operations) of one ``ordered_template`` launch over
    ``narch`` archives of ``shape``: the cube read ``reads`` times (``narch``
    by default; once for the sweep's pairs over one cube), 4 B per element,
    the weights (4 B per profile and archive) and the templates written
    (4 B per bin and archive); a multiply and an add per element and
    archive."""
    nsub, nchan, nbin = (int(v) for v in shape)
    n, p = nsub * nchan * nbin, nsub * nchan
    reads = narch if reads is None else reads
    return 4 * n * reads + 4 * p * narch + 4 * nbin * narch, 2 * n * narch


def kernel_iteration_cost(batch_shape) -> dict:
    """Bytes and float32 operations of one iteration of the two hand
    kernels over a batch ``(a, nsub, nchan, nbin)``: one
    :func:`fit_moments_cost` and one :func:`template_cost`."""
    a, *shape = (int(v) for v in batch_shape)
    costs = (fit_moments_cost(a, shape), template_cost(shape, a))
    return {"bytes_accessed": float(sum(c[0] for c in costs)),
            "flops": float(sum(c[1] for c in costs))}


def analyze_batch_route(batch_shape, cfg) -> dict | None:
    """The service's cost model of one bucket dispatch at ``batch_shape`` =
    (batch, nsub, nchan, nbin), memoized per shape bucket — the port's
    substitute for the JAX package's XLA cost and memory analysis of its
    bucket executable: :func:`kernel_iteration_cost` (one iteration, as
    XLA's analysis counts a loop body once) and the peak device bytes of
    ``parallel/autoshard.batch_working_set_bytes``.  Exported as the
    ``executable_*`` gauges at every call, the memoized ones too, so that
    the gauges follow the dispatches since the registry was last reset
    and not whether the process analyzed the bucket before; None when
    ``ICT_EXEC_ANALYSIS=0``."""
    if os.environ.get("ICT_EXEC_ANALYSIS", "1") == "0":
        return None
    bucket = tracing.shape_bucket_label(batch_shape)
    with _exec_lock:
        analysis = _exec_registry.get(bucket)
    if analysis is None:
        from iterative_cleaner_tpu_torch.parallel.autoshard import batch_working_set_bytes

        a, nsub, nchan, nbin = (int(v) for v in batch_shape)
        analysis = kernel_iteration_cost(batch_shape)
        analysis["peak_bytes"] = int(batch_working_set_bytes((nsub, nchan, nbin), cfg, True,
                                                             a))
        with _exec_lock:
            _exec_registry[bucket] = analysis
    labels = {"shape_bucket": bucket}
    for key, family in (("bytes_accessed", "executable_bytes_accessed"),
                        ("flops", "executable_flops"),
                        ("peak_bytes", "executable_peak_bytes")):
        tracing.set_gauge_labeled(family, labels, float(analysis[key]))
    return dict(analysis)


def executables_snapshot() -> dict[str, dict]:
    with _exec_lock:
        return {k: dict(v) for k, v in sorted(_exec_registry.items())}


def memory_report() -> dict:
    """Host RSS, the per-card memory view and every bucket cost model
    recorded so far, as one JSON block."""
    report: dict = {"host_rss_bytes": host_rss_bytes()}
    devices = device_snapshot()
    if devices:
        report["devices"] = devices
    execs = executables_snapshot()
    if execs:
        report["executables"] = execs
    return report
