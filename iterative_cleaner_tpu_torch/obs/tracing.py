"""Process-global metrics registry + profiling hooks.

A copy of ``iterative_cleaner_tpu/obs/tracing.py``: the monotonic counter
dict, the fixed log2-bucket latency histograms (``HIST_BOUNDS``), error
counters, labeled counters and gauges, ``observe_phase`` / ``phase``,
``snapshot`` / ``delta``, ``shape_bucket_label``, ``compile_scope`` and
``StepTimer``.  ``observe_phase`` keeps the Prometheus summary convention
(``<name>_s`` total seconds + ``<name>_n`` count).

One difference.  The JAX package accounts XLA's backend compiles through a
``jax.monitoring`` listener (``install_compile_listener``, phase
``jax_compile``).  The port's only runtime compile is the ``nvcc`` build of
a kernel library (``ops/cuda_build.py``), which calls
:func:`observe_kernel_build`: phase ``kernel_build`` stands for
``jax_compile``, and ``compiles_total`` / ``compile_seconds_total``
``{shape_bucket}`` are counted as in the JAX package, under the
:func:`compile_scope` in force on the building thread.

Everything is process-global on purpose: every layer (driver, batch
dispatch, online session) accounts into one place without plumbing a
registry object through call signatures.
"""

from __future__ import annotations

import contextlib
import threading
import time

from iterative_cleaner_tpu_torch.obs import flight


# --- the registries (one lock: a /metrics scrape sees a consistent cut) ---

#: Fixed log2 histogram bucket upper bounds (seconds): 16 finite bounds,
#: 2^-10 (~0.98 ms) through 2^5 (32 s), plus the implicit +Inf bucket.
#: Fixed, not adaptive: every phase shares one bucket layout so cross-phase
#: comparison and the Prometheus exposition stay trivial, and bucketing is
#: a 16-entry linear scan — no histogram state to size.
HIST_BOUNDS: tuple[float, ...] = tuple(2.0 ** e for e in range(-10, 6))

_counters: dict[str, float] = {}  # ict: guarded-by(_counters_lock)
_labeled: dict[tuple[str, tuple[tuple[str, str], ...]], float] = {}  # ict: guarded-by(_counters_lock)
_gauges: dict[str, float] = {}  # ict: guarded-by(_counters_lock)
_labeled_gauges: dict[tuple[str, tuple[tuple[str, str], ...]], float] = {}  # ict: guarded-by(_counters_lock)
_hists: dict[str, list[int]] = {}  # ict: guarded-by(_counters_lock)
_counters_lock = threading.Lock()


def _bucket_index(seconds: float) -> int:
    """Index of the first bound >= seconds (len(HIST_BOUNDS) = the +Inf
    bucket); a linear scan over the 16 finite bounds."""
    for i, bound in enumerate(HIST_BOUNDS):
        if seconds <= bound:
            return i
    return len(HIST_BOUNDS)


def count(name: str, inc: float = 1.0) -> None:
    """Add ``inc`` to the process-global counter ``name``."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0.0) + inc


def count_labeled(family: str, labels: dict[str, str], inc: float = 1.0) -> None:
    """Add ``inc`` to the labeled counter ``family{labels}`` — the register
    for dimensions a flat name cannot carry (route, shape bucket).  Label
    sets are expected to stay low-cardinality (shape classes, route names);
    the registry is a plain dict, so an unbounded label value would grow it
    without bound."""
    key = (family, tuple(sorted((str(k), str(v)) for k, v in labels.items())))
    with _counters_lock:
        _labeled[key] = _labeled.get(key, 0.0) + inc


def set_gauge(name: str, value: float) -> None:
    """Set the absolute value of the gauge ``name`` (last write wins — the
    register for point-in-time facts like host RSS, where a counter's
    only-up contract would lie)."""
    with _counters_lock:
        _gauges[name] = float(value)


def set_gauge_labeled(family: str, labels: dict[str, str],
                      value: float) -> None:
    """Labeled gauge (device / route / shape_bucket dimensions), absolute
    value, last write wins.  Same low-cardinality expectation as
    :func:`count_labeled`."""
    key = (family, tuple(sorted((str(k), str(v)) for k, v in labels.items())))
    with _counters_lock:
        _labeled_gauges[key] = float(value)


def max_gauge_labeled(family: str, labels: dict[str, str],
                      value: float) -> None:
    """Labeled gauge that only ratchets upward — high-water marks
    (per-route peak HBM) where a later, lower sample must not erase the
    peak the operator is alerting on."""
    key = (family, tuple(sorted((str(k), str(v)) for k, v in labels.items())))
    with _counters_lock:
        if float(value) > _labeled_gauges.get(key, float("-inf")):
            _labeled_gauges[key] = float(value)


def observe_phase(name: str, seconds: float, error: bool = False) -> None:
    """Record one completed phase: total seconds + occurrence count + the
    worst single occurrence (``<name>_max_s``) + one log2 histogram bucket.
    ``error=True`` additionally bumps ``<name>_err_n`` — failed occurrences
    still count in ``_n``/``_s`` (a failing load is still a load the
    operator wants in the latency accounting) but become visible as a
    failure *rate* on ``/metrics``."""
    with _counters_lock:
        _counters[f"{name}_s"] = _counters.get(f"{name}_s", 0.0) + seconds
        _counters[f"{name}_n"] = _counters.get(f"{name}_n", 0.0) + 1.0
        if error:
            _counters[f"{name}_err_n"] = _counters.get(f"{name}_err_n", 0.0) + 1.0
        key = f"{name}_max_s"
        if seconds > _counters.get(key, 0.0):
            _counters[key] = seconds
        hist = _hists.get(name)
        if hist is None:
            hist = _hists[name] = [0] * (len(HIST_BOUNDS) + 1)
        hist[_bucket_index(seconds)] += 1
    # Outside the lock: the flight recorder (obs/flight) keeps its own —
    # phase timings are the "what was it doing" half of a post-mortem ring.
    flight.note_phase(name, seconds, error=error)


@contextlib.contextmanager
def phase(name: str):
    """Time a block into :func:`observe_phase`.  Exceptions still count in
    the totals (see observe_phase) AND bump ``<name>_err_n``, so failure
    rates are first-class on ``/metrics`` instead of masquerading as
    successes."""
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        observe_phase(name, time.perf_counter() - t0, error=True)
        raise
    else:
        observe_phase(name, time.perf_counter() - t0)


def counters_snapshot() -> dict[str, float]:
    """Point-in-time copy of every flat counter, sorted by name (stable
    JSON — the ``/metrics.json`` payload)."""
    with _counters_lock:
        return dict(sorted(_counters.items()))


def labeled_snapshot() -> dict[tuple[str, tuple[tuple[str, str], ...]], float]:
    """Point-in-time copy of the labeled-counter registry."""
    with _counters_lock:
        return dict(sorted(_labeled.items()))


def histograms_snapshot() -> dict[str, list[int]]:
    """Point-in-time copy of every phase histogram (per-bucket counts, NOT
    cumulative; the Prometheus renderer accumulates)."""
    with _counters_lock:
        return {k: list(v) for k, v in sorted(_hists.items())}


def registry_snapshot() -> tuple[dict, dict, dict, dict, dict]:
    """(counters, labeled, gauges, labeled_gauges, histograms) under ONE
    lock hold — the scrape path's view, so a histogram's +Inf bucket can
    never disagree with its ``_n`` counter mid-observation."""
    with _counters_lock:
        return (
            dict(sorted(_counters.items())),
            dict(sorted(_labeled.items())),
            dict(sorted(_gauges.items())),
            dict(sorted(_labeled_gauges.items())),
            {k: list(v) for k, v in sorted(_hists.items())},
        )


def gauges_snapshot() -> tuple[dict, dict]:
    """Point-in-time copy of the flat and labeled gauge registries."""
    with _counters_lock:
        return dict(sorted(_gauges.items())), dict(sorted(_labeled_gauges.items()))


def snapshot(prefix: str = "") -> dict[str, float]:
    """:func:`counters_snapshot`, optionally filtered to one subsystem's
    ``prefix`` — the before/after idiom tests use so counter state from one
    case never bleeds into another's assertions (delta = snapshot() minus an
    earlier snapshot(), no global reset needed mid-process)."""
    snap = counters_snapshot()
    if not prefix:
        return snap
    return {k: v for k, v in snap.items() if k.startswith(prefix)}


def delta(before: dict[str, float], key: str) -> float:
    """Counter movement since a :func:`snapshot`; missing keys read 0."""
    return counters_snapshot().get(key, 0.0) - before.get(key, 0.0)


def reset_counters() -> None:
    """Zero every registry (tests only — production counters are cumulative
    for the life of the process, like any scrape target)."""
    with _counters_lock:
        _counters.clear()
        _labeled.clear()
        _gauges.clear()
        _labeled_gauges.clear()
        _hists.clear()


# --- compile accounting (the nvcc build of ops/cuda_build.py) ---

_tls = threading.local()


def shape_bucket_label(shape) -> str:
    """Canonical shape-bucket label: '8x16x64' (leading int dims only)."""
    return "x".join(str(int(v)) for v in shape)


@contextlib.contextmanager
def compile_scope(shape_bucket: str):
    """Attribute any kernel build that runs inside this block, on this
    thread, to ``shape_bucket``."""
    prev = getattr(_tls, "shape_bucket", "")
    _tls.shape_bucket = shape_bucket
    try:
        yield
    finally:
        _tls.shape_bucket = prev


def observe_kernel_build(seconds: float) -> None:
    """Account one kernel library build: the ``kernel_build`` phase (the
    port's counterpart of ``jax_compile``) and ``compiles_total`` /
    ``compile_seconds_total`` for the shape bucket in scope."""
    observe_phase("kernel_build", seconds)
    bucket = getattr(_tls, "shape_bucket", "") or "unscoped"
    count_labeled("compiles_total", {"shape_bucket": bucket})
    count_labeled("compile_seconds_total", {"shape_bucket": bucket}, seconds)


class StepTimer:
    """Wall-clock per iteration, reported through the progress callback.
    perf_counter: monotonic (no negative laps on wall-clock steps) and
    high-resolution (no 0.0 laps on coarse system clocks)."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self.durations: list[float] = []

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        self.durations.append(dt)
        return dt
