"""Durable performance-trend plane + live regression sentinel.

Port of ``iterative_cleaner_tpu/fleet/trends.py``.

The fleet's whole time axis used to be the 128-tick (~2-minute)
in-memory history ring (fleet/history.py): performance baselines lived
only as CI artifacts (docs/bench_baseline_cpu.json, tools/perf_gate.py),
so a production fleet that slowly lost half its throughput over a day
was invisible to every alert, SLO, and incident plane.  This module
closes that gap with three layers, all fed once per poll tick from the
SAME parsed federated exposition the history ring already records —
zero new scrape traffic:

- :class:`TrendStore` — an RRD-style multi-resolution ring set per
  tracked series: the raw per-tick point ring, then 1-minute and 1-hour
  rollup rings.  A rollup cell is the exact monoid fold
  ``(first, last, min, max, sum, n)``: counters and histogram buckets
  conserve their window delta through ``last - first`` across every
  resolution boundary (the obs/metrics merge-policy discipline — sums
  stay exact, never resampled), gauges read back min/max/mean.  The
  store is spool-persisted (``<spool>/trends/trends.json``, ``.part`` +
  ``os.replace`` atomic like the SLO budget ledger) and rehydrated on
  construction, so the rings survive a router restart byte-identical.
- **Performance fingerprints** — per ``{shape_bucket, route, replica}``
  signal key, an EWMA center plus a MAD band learned from warm
  behavior (jobs/s, phase-latency p50, cost-per-job, cache hit rate,
  ingest overlap).  The center FREEZES while a figure sits outside its
  band, so a sustained regression cannot teach the fingerprint to
  accept it.  Fingerprints export in a versioned JSON grammar
  (:data:`FINGERPRINT_GRAMMAR`) that the cost-steered
  placement ranker can consume unchanged.
- **The regression sentinel** — a live figure outside its band for K
  consecutive windows publishes ``ict_fleet_perf_regression{signal,...}``
  = 1 (every key that EVER fired stays present at 0 afterwards — the
  alert engine freezes on missing series, so resolution must be a
  value, not an absence), which a pre-installed ``source="trend"`` rule
  turns into a real alert-engine firing; the plane also writes a trend
  incident bundle carrying the offending trend window, the violated
  fingerprint, and — where the signal is machine-independent — a
  cross-check against the checked-in bench baseline, so CI's perf
  contract finally has a production twin.

Surfaces: ``GET /fleet/trends`` (family/window/resolution/signal
query), the ``ict-clean-torch trends`` CLI one-shot (:func:`trends_main`),
and the fleet_top TREND section (both render through
:func:`render_trends`/:func:`sparkline` here, one implementation).

Locking: the plane and store own their locks, acquired strictly AFTER
the router's RLock (the lock-order discipline) and never while calling out;
persistence I/O happens under a separate io lock with the state
snapshotted first, the SloPlane model.  Docs:
docs/OBSERVABILITY.md "Performance trends & regression sentinel".
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from dataclasses import dataclass, field

from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics
from iterative_cleaner_tpu_torch.obs.metrics import MetricFamily

#: Persisted-store grammar version (bump on layout change; rehydrate
#: refuses a version it does not speak rather than guessing).
TRENDS_VERSION = 1
#: The fingerprint export grammar the placement ranker
#: consumes: {"grammar": "ict-fingerprints", "version": 1, ...}.
FINGERPRINT_GRAMMAR = "ict-fingerprints"
FINGERPRINT_VERSION = 1

#: Rollup resolutions in seconds, coarsest last.  The raw tier is
#: per-poll-tick (no fixed wall period — whatever cadence feeds it).
RESOLUTIONS = (60, 3600)

#: Ring bounds per tier: 128 raw ticks (the history-ring default), six
#: hours of minutes, one week of hours — a few hundred cells per series
#: regardless of how long the router lives.
DEFAULT_KEEP_RAW = 128
DEFAULT_KEEP_BY_RES = {60: 360, 3600: 168}

#: Family-name prefixes tracked by default.  ``ict_fleet_`` covers the
#: router registry + every merged family; per-replica signals ride the
#: relabeled originals their signal specs name explicitly.
DEFAULT_PREFIXES = ("ict_fleet_",)

#: Trend incident bundles retained on disk (oldest swept beyond it) —
#: the alert-bundle bound, same rationale.
MAX_TREND_BUNDLES_KEPT = 20

#: Sentinel defaults: a fingerprint arms after this many accepted
#: windows, fires after this many consecutive out-of-band windows, and
#: the band half-width is band_mad * max(MAD, rel_floor * |center|).
DEFAULT_MIN_SAMPLES = 8
DEFAULT_SENTINEL_K = 3
DEFAULT_BAND_MAD = 4.0
DEFAULT_REL_FLOOR = 0.05
#: EWMA smoothing for the fingerprint center.
EWMA_ALPHA = 0.3
#: Accepted values retained for the MAD estimate.
MAD_WINDOW = 32

SIGNAL_MODES = ("gauge", "ratio_delta", "hist_quantile")
SIGNAL_DIRECTIONS = ("low", "high", "both")


# --- rollup cells: the exact monoid -------------------------------------


def cell_new(ts: float, value: float, res: int) -> dict:
    """Open a rollup cell for the ``res``-second bucket holding ``ts``."""
    return {"t0": int(ts // res) * res, "first": value, "last": value,
            "min": value, "max": value, "sum": value, "n": 1}


def cell_add(cell: dict, value: float) -> None:
    """Fold one raw point into an open cell (exact: no resampling)."""
    cell["last"] = value
    if value < cell["min"]:
        cell["min"] = value
    if value > cell["max"]:
        cell["max"] = value
    cell["sum"] += value
    cell["n"] += 1


def merge_cells(cells: list[dict], res: int) -> dict:
    """Fold finer-resolution cells (time-ordered) into one coarser cell —
    the associative monoid the cross-boundary exactness tests pin:
    ``first``/``last`` come from the edge cells (counter deltas conserve
    exactly), ``min``/``max`` fold, ``sum``/``n`` add IN ORDER, so the
    merged cell equals the cell built directly from the raw points."""
    if not cells:
        raise ValueError("merge_cells needs at least one cell")
    out = {"t0": int(cells[0]["t0"] // res) * res,
           "first": cells[0]["first"], "last": cells[-1]["last"],
           "min": cells[0]["min"], "max": cells[0]["max"],
           "sum": cells[0]["sum"], "n": cells[0]["n"]}
    for cell in cells[1:]:
        if cell["min"] < out["min"]:
            out["min"] = cell["min"]
        if cell["max"] > out["max"]:
            out["max"] = cell["max"]
        out["sum"] += cell["sum"]
        out["n"] += cell["n"]
    return out


def cell_reading(cell: dict, kind: str | None) -> float:
    """One figure from a cell, kind-aware: counters (and histogram
    ``_bucket``/``_count``/``_sum`` samples, counter-kind by grammar)
    report the exact in-cell delta ``last - first``; gauges report the
    in-cell mean.  Readers wanting envelope bands use min/max directly."""
    if kind == "counter":
        return cell["last"] - cell["first"]
    return cell["sum"] / cell["n"] if cell["n"] else 0.0


# --- signal specs --------------------------------------------------------


@dataclass(frozen=True)
class SignalSpec:
    """One fingerprinted figure derived from the trend store per window.

    Modes: ``gauge`` (latest value of ``family``, summed over series
    sharing a group key), ``ratio_delta`` (windowed counter delta of
    ``num_family``/``num_labels`` over ``den_family``/``den_labels``),
    ``hist_quantile`` (quantile ``q`` of ``family``'s windowed bucket
    deltas).  ``group_by`` names the label keys that split fingerprint
    keys; ``direction`` says which side of the band is a regression
    (``low``: the figure dropping is bad — throughput, hit rates;
    ``high``: rising is bad — latency, cost).  ``baseline_key`` names a
    machine-independent figure in docs/bench_baseline_cpu.json the
    incident bundle cross-checks (empty = not comparable)."""

    name: str
    mode: str
    direction: str = "low"
    family: str = ""
    labels: tuple = ()            # ((k, v), ...) selector subset
    num_family: str = ""
    num_labels: tuple = ()
    den_family: str = ""
    den_labels: tuple = ()
    group_by: tuple = ()
    q: float = 0.5
    window: int = 8               # raw ticks per fingerprint window
    min_samples: int = 0          # 0 = the plane default
    sentinel_k: int = 0           # 0 = the plane default
    band_mad: float = 0.0         # 0 = the plane default
    rel_floor: float = DEFAULT_REL_FLOOR
    baseline_key: str = ""

    def to_json(self) -> dict:
        return {
            "name": self.name, "mode": self.mode,
            "direction": self.direction, "family": self.family,
            "labels": dict(self.labels),
            "num_family": self.num_family,
            "num_labels": dict(self.num_labels),
            "den_family": self.den_family,
            "den_labels": dict(self.den_labels),
            "group_by": list(self.group_by), "q": self.q,
            "window": self.window, "min_samples": self.min_samples,
            "sentinel_k": self.sentinel_k, "band_mad": self.band_mad,
            "rel_floor": self.rel_floor,
            "baseline_key": self.baseline_key,
        }


def parse_signal(spec: dict) -> SignalSpec:
    """Validate one declarative signal spec (the ``--trend_signal`` JSON
    shape) into a :class:`SignalSpec`; raises ValueError with the field
    that failed — validation happens at the CLI surface, never on the
    poll thread."""
    if not isinstance(spec, dict):
        raise ValueError(f"signal spec must be a JSON object, got "
                         f"{type(spec).__name__}")
    name = str(spec.get("name", ""))
    if not name:
        raise ValueError("signal spec needs a non-empty 'name'")
    mode = str(spec.get("mode", "gauge"))
    if mode not in SIGNAL_MODES:
        raise ValueError(f"signal {name!r}: mode must be one of "
                         f"{SIGNAL_MODES}, got {mode!r}")
    direction = str(spec.get("direction", "low"))
    if direction not in SIGNAL_DIRECTIONS:
        raise ValueError(f"signal {name!r}: direction must be one of "
                         f"{SIGNAL_DIRECTIONS}, got {direction!r}")
    if mode == "ratio_delta":
        if not spec.get("num_family") or not spec.get("den_family"):
            raise ValueError(f"signal {name!r}: ratio_delta needs "
                             "'num_family' and 'den_family'")
    elif not spec.get("family"):
        raise ValueError(f"signal {name!r}: mode {mode!r} needs 'family'")
    window = int(spec.get("window", 8))
    if window < 1:
        raise ValueError(f"signal {name!r}: window must be >= 1")
    q = float(spec.get("q", 0.5))
    if not 0.0 < q < 1.0:
        raise ValueError(f"signal {name!r}: q must be in (0, 1)")

    def pairs(key: str) -> tuple:
        d = spec.get(key) or {}
        if not isinstance(d, dict):
            raise ValueError(f"signal {name!r}: {key!r} must be an object")
        return tuple(sorted((str(k), str(v)) for k, v in d.items()))

    return SignalSpec(
        name=name, mode=mode, direction=direction,
        family=str(spec.get("family", "")), labels=pairs("labels"),
        num_family=str(spec.get("num_family", "")),
        num_labels=pairs("num_labels"),
        den_family=str(spec.get("den_family", "")),
        den_labels=pairs("den_labels"),
        group_by=tuple(str(k) for k in spec.get("group_by", ())),
        q=q, window=window,
        min_samples=int(spec.get("min_samples", 0)),
        sentinel_k=int(spec.get("sentinel_k", 0)),
        band_mad=float(spec.get("band_mad", 0.0)),
        rel_floor=float(spec.get("rel_floor", DEFAULT_REL_FLOOR)),
        baseline_key=str(spec.get("baseline_key", "")))


def default_signals() -> list[SignalSpec]:
    """The shipped fingerprint set — every figure the plane watches, each
    derived from families the federated exposition already carries:
    warm jobs/s per replica (the capacity model's service rate), dispatch
    phase-latency p50 per phase, fleet cost-per-job, per-bucket result
    cache hit rate, and per-replica ingest overlap efficiency (the
    ``ict_ingest_last_overlap_efficiency`` gauge the daemon tick
    publishes; its baseline twin is machine-independent enough to
    cross-check — an efficiency ratio, not a wall-clock figure)."""
    return [
        SignalSpec(name="warm_jobs_per_s", mode="gauge", direction="low",
                   family="ict_fleet_capacity_replica_service_rate",
                   group_by=("replica",)),
        SignalSpec(name="phase_p50_s", mode="hist_quantile",
                   direction="high",
                   family="ict_fleet_phase_duration_seconds",
                   group_by=("phase",), q=0.5),
        SignalSpec(name="cost_per_job_s", mode="ratio_delta",
                   direction="high",
                   num_family="ict_fleet_cost_device_seconds_total",
                   den_family="ict_fleet_cost_jobs_total"),
        SignalSpec(name="cache_hit_rate", mode="ratio_delta",
                   direction="low",
                   num_family="ict_fleet_result_cache_total",
                   num_labels=(("outcome", "hit"),),
                   den_family="ict_fleet_result_cache_total",
                   group_by=("shape_bucket",)),
        SignalSpec(name="ingest_overlap", mode="gauge", direction="low",
                   family="ict_ingest_last_overlap_efficiency",
                   group_by=("replica",),
                   baseline_key="overlap_efficiency"),
    ]


# --- fingerprints --------------------------------------------------------


class Fingerprint:
    """EWMA center + MAD band for one (signal, group-key) figure.

    Not thread-safe on its own — mutated only under the owning plane's
    lock.  The center and the MAD window update ONLY from in-band
    (accepted) figures: while a value sits outside the band the
    fingerprint freezes, so a sustained regression keeps violating
    instead of being learned as the new normal."""

    def __init__(self) -> None:
        self.center: float | None = None
        self.values: collections.deque = collections.deque(maxlen=MAD_WINDOW)
        self.n = 0               # accepted (in-band) observations
        self.streak = 0          # consecutive out-of-band windows
        self.last: float | None = None
        self.last_band: tuple | None = None   # (lo, hi) at last eval
        self.firing = False

    def _mad(self) -> float:
        if not self.values:
            return 0.0
        xs = sorted(self.values)
        med = xs[len(xs) // 2]
        devs = sorted(abs(x - med) for x in xs)
        return devs[len(devs) // 2]

    def band(self, band_mad: float, rel_floor: float) -> tuple | None:
        """(lo, hi) or None before the center exists."""
        if self.center is None:
            return None
        half = band_mad * max(self._mad(), rel_floor * abs(self.center))
        return (self.center - half, self.center + half)

    def observe(self, x: float, *, direction: str, min_samples: int,
                sentinel_k: int, band_mad: float,
                rel_floor: float) -> dict:
        """Feed one window figure; returns the transition record:
        ``{"armed", "violating", "fired", "resolved"}`` (fired/resolved
        are the EDGES — fired only on the window the streak reaches K,
        resolved only on the first in-band window after a firing)."""
        self.last = x
        armed = self.n >= max(min_samples, 2)
        lo_hi = self.band(band_mad, rel_floor) if armed else None
        self.last_band = lo_hi
        violating = False
        if lo_hi is not None:
            lo, hi = lo_hi
            if direction in ("low", "both") and x < lo:
                violating = True
            if direction in ("high", "both") and x > hi:
                violating = True
        fired = resolved = False
        if violating:
            self.streak += 1
            if self.streak >= max(sentinel_k, 1) and not self.firing:
                self.firing = True
                fired = True
        else:
            if self.firing:
                self.firing = False
                resolved = True
            self.streak = 0
            # Accept: the figure teaches the fingerprint.
            self.center = (x if self.center is None
                           else (1.0 - EWMA_ALPHA) * self.center
                           + EWMA_ALPHA * x)
            self.values.append(x)
            self.n += 1
        return {"armed": armed, "violating": violating,
                "fired": fired, "resolved": resolved}

    def to_json(self) -> dict:
        return {"center": self.center, "values": list(self.values),
                "n": self.n, "streak": self.streak, "last": self.last,
                "last_band": (list(self.last_band)
                              if self.last_band else None),
                "firing": self.firing}

    @classmethod
    def from_json(cls, obj: dict) -> "Fingerprint":
        fp = cls()
        fp.center = obj.get("center")
        fp.values = collections.deque(
            (float(v) for v in obj.get("values", ())), maxlen=MAD_WINDOW)
        fp.n = int(obj.get("n", 0))
        fp.streak = int(obj.get("streak", 0))
        fp.last = obj.get("last")
        band = obj.get("last_band")
        fp.last_band = tuple(band) if band else None
        fp.firing = bool(obj.get("firing", False))
        return fp


# --- the store -----------------------------------------------------------


def _match(label_pairs: tuple, want: tuple) -> bool:
    if not want:
        return True
    d = dict(label_pairs)
    return all(d.get(k) == v for k, v in want)


class TrendStore:
    """Multi-resolution ring set per tracked series, fed once per poll
    tick from an already-parsed exposition.  Own lock, acquired strictly
    after the router's RLock, never held while calling out; every read
    hands back copies, so records never escape mutation."""

    def __init__(self, keep_raw: int = DEFAULT_KEEP_RAW,
                 prefixes: tuple = DEFAULT_PREFIXES,
                 extra_families: tuple = ()) -> None:
        self.keep_raw = max(int(keep_raw), 1)
        self.prefixes = tuple(prefixes)
        #: Exact family names tracked regardless of prefix — the
        #: families the signal specs reference (per-replica relabeled
        #: originals live outside the ict_fleet_ prefix).
        self.extra_families = tuple(extra_families)
        self._lock = threading.Lock()
        # (sample_name, label_pairs) -> series record
        self._series: dict[tuple, dict] = {}  # ict: guarded-by(self._lock)
        self._ticks = 0  # ict: guarded-by(self._lock)

    def _tracked(self, family_name: str) -> bool:
        return (family_name in self.extra_families
                or any(family_name.startswith(p) for p in self.prefixes))

    def append(self, families: list[MetricFamily], ts: float) -> dict:
        """Fold one tick's parsed exposition in; returns
        ``{"points": n, "rollups": {"60s": n, "3600s": n}}`` (cells
        SEALED this tick, the counter mirrors' delta feed)."""
        sealed = {res: 0 for res in RESOLUTIONS}
        points = 0
        with self._lock:
            self._ticks += 1
            for fam in families:
                if not self._tracked(fam.name):
                    continue
                for name, labels, raw in fam.samples:
                    try:
                        value = obs_metrics.sample_value(raw)
                    except ValueError:
                        continue
                    if value != value or value in (float("inf"),
                                                   float("-inf")):
                        continue   # bands over IEEE specials are noise
                    key = (name, labels)
                    rec = self._series.get(key)
                    if rec is None:
                        rec = {
                            "family": fam.name, "kind": fam.kind,
                            "sample": name, "labels": labels,
                            "raw": collections.deque(maxlen=self.keep_raw),
                            "rollups": {
                                res: {"open": None,
                                      "sealed": collections.deque(
                                          maxlen=DEFAULT_KEEP_BY_RES[res])}
                                for res in RESOLUTIONS},
                        }
                        self._series[key] = rec
                    rec["raw"].append((round(float(ts), 3), value))
                    points += 1
                    for res in RESOLUTIONS:
                        tier = rec["rollups"][res]
                        cell = tier["open"]
                        t0 = int(ts // res) * res
                        if cell is not None and cell["t0"] != t0:
                            tier["sealed"].append(cell)
                            sealed[res] += 1
                            cell = None
                        if cell is None:
                            tier["open"] = cell_new(ts, value, res)
                        else:
                            cell_add(cell, value)
        return {"points": points,
                "rollups": {f"{res}s": sealed[res] for res in RESOLUTIONS}}

    def ticks(self) -> int:
        with self._lock:
            return self._ticks

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    # --- signal-evaluation reads (copies, computed under the lock) ---

    def gauge_latest(self, family: str, labels: tuple,
                     group_by: tuple) -> dict[tuple, float]:
        """{group-key label pairs -> sum of latest values} over every
        series of ``family`` matching the ``labels`` selector subset."""
        out: dict[tuple, float] = {}
        with self._lock:
            for (name, lp), rec in self._series.items():
                if rec["family"] != family or not rec["raw"]:
                    continue
                if name != family or not _match(lp, labels):
                    continue
                d = dict(lp)
                key = tuple((g, d.get(g, "")) for g in group_by)
                out[key] = out.get(key, 0.0) + rec["raw"][-1][1]
        return out

    def delta_sum(self, family: str, labels: tuple, group_by: tuple,
                  window: int) -> dict[tuple, float]:
        """{group-key -> summed counter delta over the last ``window``
        raw ticks}, per-series deltas clamped at 0 (counter resets must
        not go negative)."""
        out: dict[tuple, float] = {}
        with self._lock:
            for (name, lp), rec in self._series.items():
                if rec["family"] != family or len(rec["raw"]) < 2:
                    continue
                if name != family or not _match(lp, labels):
                    continue
                pts = list(rec["raw"])[-(window + 1):]
                delta = max(pts[-1][1] - pts[0][1], 0.0)
                d = dict(lp)
                key = tuple((g, d.get(g, "")) for g in group_by)
                out[key] = out.get(key, 0.0) + delta
        return out

    def hist_delta_cum(self, family: str, labels: tuple, group_by: tuple,
                       window: int) -> dict[tuple, dict]:
        """{group-key -> {le -> windowed bucket-count delta}} for
        ``family``'s ``_bucket`` samples — the shape
        ``obs.metrics.quantile_from_cum`` consumes."""
        bucket = family + "_bucket"
        out: dict[tuple, dict] = {}
        with self._lock:
            for (name, lp), rec in self._series.items():
                if name != bucket or len(rec["raw"]) < 2:
                    continue
                if not _match(lp, labels):
                    continue
                d = dict(lp)
                raw_le = d.pop("le", "+Inf")
                try:
                    le = obs_metrics.sample_value(raw_le)
                except ValueError:
                    continue
                pts = list(rec["raw"])[-(window + 1):]
                delta = max(pts[-1][1] - pts[0][1], 0.0)
                key = tuple((g, d.get(g, "")) for g in group_by)
                cum = out.setdefault(key, {})
                cum[le] = cum.get(le, 0.0) + delta
        return out

    # --- views / persistence ---

    def _series_json(self, rec: dict, resolution: str,
                     window: int | None) -> dict:
        obj = {"family": rec["family"], "kind": rec["kind"],
               "sample": rec["sample"],
               "labels": [[k, v] for k, v in rec["labels"]]}
        if resolution == "raw":
            pts = list(rec["raw"])
            if window:
                pts = pts[-window:]
            obj["points"] = [[t, v] for t, v in pts]
        else:
            res = int(resolution)
            tier = rec["rollups"][res]
            cells = list(tier["sealed"])
            if tier["open"] is not None:
                cells = cells + [dict(tier["open"])]
            if window:
                cells = cells[-window:]
            obj["cells"] = [dict(c) for c in cells]
        return obj

    def query(self, family: str = "", resolution: str = "raw",
              window: int | None = None) -> list[dict]:
        """Series matching the ``family`` name prefix (all when empty)
        at one resolution (``raw`` | ``60`` | ``3600``), each series'
        newest ``window`` entries; sorted for a deterministic reply."""
        if resolution not in ("raw",) + tuple(str(r) for r in RESOLUTIONS):
            raise ValueError(f"bad resolution {resolution!r}; want raw"
                             + "".join(f"|{r}" for r in RESOLUTIONS))
        with self._lock:
            recs = [rec for (name, _lp), rec in sorted(self._series.items())
                    if not family or name.startswith(family)]
            return [self._series_json(rec, resolution, window)
                    for rec in recs]

    def inventory(self) -> list[dict]:
        """Name/labels/point-count rows for every tracked series — the
        no-filter ``GET /fleet/trends`` body stays bounded."""
        with self._lock:
            return [{"family": rec["family"], "sample": rec["sample"],
                     "kind": rec["kind"],
                     "labels": [[k, v] for k, v in rec["labels"]],
                     "raw_points": len(rec["raw"]),
                     "cells": {f"{res}s":
                               len(rec["rollups"][res]["sealed"])
                               + (1 if rec["rollups"][res]["open"]
                                  is not None else 0)
                               for res in RESOLUTIONS}}
                    for (_n, _lp), rec in sorted(self._series.items())]

    def to_json(self) -> dict:
        """The full persisted shape — lossless, deterministic order, so
        dump -> load -> dump is byte-identical (floats round-trip via
        repr under json)."""
        with self._lock:
            series = []
            for (name, lp), rec in sorted(self._series.items()):
                series.append({
                    "family": rec["family"], "kind": rec["kind"],
                    "sample": name,
                    "labels": [[k, v] for k, v in lp],
                    "raw": [[t, v] for t, v in rec["raw"]],
                    "rollups": {
                        str(res): {
                            "open": (dict(rec["rollups"][res]["open"])
                                     if rec["rollups"][res]["open"]
                                     is not None else None),
                            "sealed": [dict(c) for c in
                                       rec["rollups"][res]["sealed"]]}
                        for res in RESOLUTIONS},
                })
            return {"version": TRENDS_VERSION, "grammar": "ict-trends",
                    "ticks": self._ticks, "keep_raw": self.keep_raw,
                    "series": series}

    def load_json(self, obj: dict) -> None:
        """Rehydrate from a persisted shape (tolerant of a missing or
        foreign file by raising ValueError for the caller to swallow;
        a version this code does not speak is refused, not guessed)."""
        if int(obj.get("version", -1)) != TRENDS_VERSION:
            raise ValueError(f"trend store version "
                             f"{obj.get('version')!r} != {TRENDS_VERSION}")
        series: dict[tuple, dict] = {}
        for row in obj.get("series", ()):
            lp = tuple((str(k), str(v)) for k, v in row.get("labels", ()))
            key = (str(row["sample"]), lp)
            rollups = {}
            for res in RESOLUTIONS:
                tier = (row.get("rollups") or {}).get(str(res)) or {}
                rollups[res] = {
                    "open": (dict(tier["open"])
                             if tier.get("open") else None),
                    "sealed": collections.deque(
                        (dict(c) for c in tier.get("sealed", ())),
                        maxlen=DEFAULT_KEEP_BY_RES[res])}
            series[key] = {
                "family": str(row["family"]), "kind": row.get("kind"),
                "sample": str(row["sample"]), "labels": lp,
                "raw": collections.deque(
                    ((float(t), float(v)) for t, v in row.get("raw", ())),
                    maxlen=self.keep_raw),
                "rollups": rollups,
            }
        with self._lock:
            self._series = series
            self._ticks = int(obj.get("ticks", 0))


# --- trend incident bundles ---------------------------------------------


def write_trend_bundle(directory: str, *, firing: dict, fingerprint: dict,
                       window: list[dict],
                       baseline_check: dict | None = None) -> str | None:
    """One self-contained regression bundle under ``directory``:
    ``trend-<unixms>-<hex6>/`` holding ``manifest.json`` (the firing,
    the violated fingerprint, the baseline cross-check) and
    ``window.json`` (the offending trend window, replottable).  Built
    under a ``.part`` name and renamed; oldest beyond
    :data:`MAX_TREND_BUNDLES_KEPT` swept; returns the path or None —
    forensics must never become a second failure (the
    ``write_incident_bundle`` contract)."""
    try:
        os.makedirs(directory, exist_ok=True)
        name = (f"trend-{int(time.time() * 1000):013d}-"
                f"{uuid.uuid4().hex[:6]}")
        final = os.path.join(directory, name)
        tmp = f"{final}.part"
        os.makedirs(tmp)
        manifest = {
            "reason": "perf_regression",
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "firing": firing,
            "fingerprint": fingerprint,
            "baseline_check": baseline_check,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=1, default=str)
            fh.write("\n")
        with open(os.path.join(tmp, "window.json"), "w") as fh:
            json.dump({"series": window}, fh, indent=1, default=str)
            fh.write("\n")
        os.replace(tmp, final)
        bundles = sorted(n for n in os.listdir(directory)
                         if n.startswith("trend-")
                         and not n.endswith(".part"))
        for old in bundles[:max(0, len(bundles)
                                - MAX_TREND_BUNDLES_KEPT)]:
            shutil.rmtree(os.path.join(directory, old),
                          ignore_errors=True)
        return final
    except OSError:
        return None


def list_trend_bundles(directory: str) -> list[dict]:
    """Bundle inventory for the HTTP view (newest first)."""
    try:
        names = sorted((n for n in os.listdir(directory)
                        if n.startswith("trend-")
                        and not n.endswith(".part")), reverse=True)
    except OSError:
        return []
    out = []
    for name in names:
        row = {"name": name, "path": os.path.join(directory, name)}
        try:
            with open(os.path.join(directory, name,
                                   "manifest.json")) as fh:
                manifest = json.load(fh)
            row["ts"] = manifest.get("ts")
            row["signal"] = (manifest.get("firing") or {}).get("signal")
            row["labels"] = (manifest.get("firing") or {}).get("labels")
        except (OSError, ValueError):
            pass
        out.append(row)
    return out


# --- the plane -----------------------------------------------------------


@dataclass
class TrendConfig:
    spool_dir: str = ""           # "" = in-memory only (tests)
    keep_raw: int = DEFAULT_KEEP_RAW
    signals: tuple = ()           # SignalSpec list ((), = default set)
    sentinel_k: int = DEFAULT_SENTINEL_K
    min_samples: int = DEFAULT_MIN_SAMPLES
    band_mad: float = DEFAULT_BAND_MAD
    persist_every: int = 16       # ticks between spool writes
    baseline_path: str = ""       # bench baseline for cross-checks
    quiet: bool = False


class TrendPlane:
    """Store + fingerprints + sentinel, owned by the router.

    ``tick`` runs on the poll thread once per tick; the HTTP views and
    the CLI read through :meth:`trends_json`/:meth:`fingerprints_json`.
    Own lock after the router's; spool writes snapshot under the state
    lock, then write under a separate io lock (the SloPlane model)."""

    def __init__(self, cfg: TrendConfig) -> None:
        self.cfg = cfg
        self.signals = list(cfg.signals) or default_signals()
        extra = tuple(sorted({f for s in self.signals
                              for f in (s.family, s.num_family,
                                        s.den_family,
                                        (s.family + "_bucket")
                                        if s.mode == "hist_quantile"
                                        else "") if f}))
        self.store = TrendStore(keep_raw=cfg.keep_raw,
                                extra_families=extra)
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        # (signal, group-key pairs) -> Fingerprint
        self._fps: dict[tuple, Fingerprint] = {}  # ict: guarded-by(self._lock)
        # Keys that EVER fired: kept present at 0 in the regression
        # gauge after recovery — the alert engine freezes on a missing
        # series, so resolution must be a value, not an absence.
        self._ever_fired: set = set()  # ict: guarded-by(self._lock)
        self._ticks = 0  # ict: guarded-by(self._lock)
        self._regressions_total = 0  # lifetime firings  # ict: guarded-by(self._lock)
        self._persist_total = 0  # ict: guarded-by(self._io_lock)
        self._persist_errors = 0  # ict: guarded-by(self._io_lock)
        self._baseline: dict | None = None
        if cfg.baseline_path:
            try:
                with open(cfg.baseline_path) as fh:
                    self._baseline = json.load(fh)
            except (OSError, ValueError):
                self._baseline = None
        if cfg.spool_dir:
            self._rehydrate()

    # --- persistence (the SLO ledger model) ---

    @property
    def trend_dir(self) -> str:
        return os.path.join(self.cfg.spool_dir, "trends")

    @property
    def store_path(self) -> str:
        return os.path.join(self.trend_dir, "trends.json")

    @property
    def bundle_dir(self) -> str:
        return os.path.join(self.cfg.spool_dir, "trend-incidents")

    def to_json(self) -> dict:
        """Everything persisted: the store plus fingerprint/sentinel
        state, deterministic order (byte-identical across a
        dump -> load -> dump round trip)."""
        doc = self.store.to_json()
        with self._lock:
            doc["fingerprints"] = [
                {"signal": sig, "labels": [[k, v] for k, v in key],
                 "state": fp.to_json()}
                for (sig, key), fp in sorted(self._fps.items())]
            doc["ever_fired"] = [
                {"signal": sig, "labels": [[k, v] for k, v in key]}
                for sig, key in sorted(self._ever_fired)]
            doc["plane_ticks"] = self._ticks
            doc["regressions_total"] = self._regressions_total
        return doc

    def persist(self, force: bool = False) -> bool:
        """Atomic spool write (``.part`` + rename) every
        ``persist_every`` ticks and on router stop; never raises."""
        if not self.cfg.spool_dir:
            return False
        with self._lock:
            due = force or (self.cfg.persist_every > 0
                            and self._ticks % self.cfg.persist_every == 0)
        if not due:
            return False
        doc = self.to_json()
        with self._io_lock:
            try:
                os.makedirs(self.trend_dir, exist_ok=True)
                part = self.store_path + ".part"
                with open(part, "w") as fh:
                    json.dump(doc, fh, separators=(",", ":"))
                    fh.write("\n")
                os.replace(part, self.store_path)
                self._persist_total += 1
                return True
            except OSError:
                self._persist_errors += 1
                return False

    def _rehydrate(self) -> None:
        """Tolerant restart read: a missing/corrupt/foreign file starts
        fresh (the ledger never blocks a router boot)."""
        try:
            with open(self.store_path) as fh:
                doc = json.load(fh)
            self.store.load_json(doc)
            with self._lock:
                self._fps = {
                    (str(row["signal"]),
                     tuple((str(k), str(v))
                           for k, v in row.get("labels", ()))):
                    Fingerprint.from_json(row.get("state", {}))
                    for row in doc.get("fingerprints", ())}
                self._ever_fired = {
                    (str(row["signal"]),
                     tuple((str(k), str(v))
                           for k, v in row.get("labels", ())))
                    for row in doc.get("ever_fired", ())}
                self._ticks = int(doc.get("plane_ticks", 0))
                self._regressions_total = int(
                    doc.get("regressions_total", 0))
        except (OSError, ValueError, KeyError, TypeError):
            pass

    def persist_stats(self) -> dict:
        with self._io_lock:
            return {"persist_total": self._persist_total,
                    "persist_errors": self._persist_errors}

    # --- per-tick evaluation ---

    def _spec_params(self, spec: SignalSpec) -> dict:
        return {
            "direction": spec.direction,
            "min_samples": spec.min_samples or self.cfg.min_samples,
            "sentinel_k": spec.sentinel_k or self.cfg.sentinel_k,
            "band_mad": spec.band_mad or self.cfg.band_mad,
            "rel_floor": spec.rel_floor,
        }

    def _figures(self, spec: SignalSpec) -> dict[tuple, float]:
        """{group-key pairs -> this window's figure} for one signal."""
        if spec.mode == "gauge":
            return self.store.gauge_latest(spec.family, spec.labels,
                                           spec.group_by)
        if spec.mode == "ratio_delta":
            num = self.store.delta_sum(spec.num_family, spec.num_labels,
                                       spec.group_by, spec.window)
            den = self.store.delta_sum(spec.den_family, spec.den_labels,
                                       spec.group_by, spec.window)
            return {key: num.get(key, 0.0) / den[key]
                    for key in den if den[key] > 0.0}
        cums = self.store.hist_delta_cum(spec.family, spec.labels,
                                         spec.group_by, spec.window)
        out: dict[tuple, float] = {}
        for key, cum in cums.items():
            if sum(cum.values()) <= 0.0:
                continue
            est = obs_metrics.quantile_from_cum(cum, spec.q)
            if est is not None:
                out[key] = est
        return out

    def _baseline_check(self, spec: SignalSpec,
                        value: float) -> dict | None:
        """Cross-check a machine-independent signal against the
        checked-in bench baseline; None when not comparable (no
        baseline_key, no baseline file, or a non-numeric figure) —
        honesty over coverage."""
        if not spec.baseline_key or not self._baseline:
            return None
        ref = self._baseline
        for part in spec.baseline_key.split("."):
            if not isinstance(ref, dict) or part not in ref:
                return None
            ref = ref[part]
        if not isinstance(ref, (int, float)) or isinstance(ref, bool):
            return None
        ref = float(ref)
        within = (value >= 0.5 * ref if spec.direction == "low"
                  else value <= 2.0 * ref)
        return {"baseline_key": spec.baseline_key, "baseline": ref,
                "live": value, "machine_independent": True,
                "within_2x": bool(within)}

    def tick(self, families: list[MetricFamily], ts: float) -> dict:
        """One poll tick: fold the exposition into the store, evaluate
        due signals, update fingerprints, and return everything the
        router fans out: sealed-rollup counts, the regression gauge
        family, and the fired/resolved transition edges (each fired
        record already carries its bundle payload)."""
        stats = self.store.append(families, ts)
        with self._lock:
            self._ticks += 1
            tick = self._ticks
        fired: list[dict] = []
        resolved: list[dict] = []
        for spec in self.signals:
            if tick % max(spec.window, 1) != 0:
                continue
            figures = self._figures(spec)
            params = self._spec_params(spec)
            for key, value in sorted(figures.items()):
                with self._lock:
                    fp = self._fps.setdefault((spec.name, key),
                                              Fingerprint())
                    edge = fp.observe(value, **params)
                    if edge["fired"]:
                        self._ever_fired.add((spec.name, key))
                        self._regressions_total += 1
                    fp_json = fp.to_json()
                if edge["fired"] or edge["resolved"]:
                    rec = {"signal": spec.name,
                           "labels": dict(key),
                           "value": value,
                           "band": fp_json["last_band"],
                           "center": fp_json["center"],
                           "streak": fp_json["streak"],
                           "spec": spec.to_json(),
                           "fingerprint": fp_json}
                    if edge["fired"]:
                        rec["baseline_check"] = self._baseline_check(
                            spec, value)
                        rec["window"] = self._firing_window(spec, key)
                        fired.append(rec)
                    else:
                        resolved.append(rec)
        self.persist()
        return {**stats, "fired": fired, "resolved": resolved,
                "gauge": self.gauge_family(),
                "regressions_total": self.regressions_total()}

    def _firing_window(self, spec: SignalSpec, key: tuple) -> list[dict]:
        """The offending trend window for the bundle: the raw rings of
        every series feeding this signal, filtered to the firing group
        key so the bundle stays small and replottable."""
        fams = [f for f in (spec.family, spec.num_family, spec.den_family)
                if f]
        out: list[dict] = []
        want = tuple(key)
        for fam in fams:
            for row in self.store.query(family=fam, resolution="raw"):
                d = dict(tuple(p) for p in row["labels"])
                if all(d.get(k) == v for k, v in want if v):
                    out.append(row)
        return out

    def gauge_family(self) -> dict[tuple, float]:
        """The ``ict_fleet_perf_regression`` family body for
        ``RouterMetrics.replace_gauge_family``: 1.0 per firing
        fingerprint key, 0.0 for every armed or ever-fired key —
        recovery reads as zero, never as absence."""
        with self._lock:
            out: dict[tuple, float] = {}
            for (sig, key), fp in self._fps.items():
                if fp.n >= 2 or fp.firing or (sig, key) in self._ever_fired:
                    labels = (("signal", sig),) + tuple(key)
                    out[labels] = 1.0 if fp.firing else 0.0
            for sig, key in self._ever_fired:
                labels = (("signal", sig),) + tuple(key)
                out.setdefault(labels, 0.0)
            return out

    def regressions_total(self) -> int:
        with self._lock:
            return self._regressions_total

    def firing(self) -> list[dict]:
        with self._lock:
            return [{"signal": sig, "labels": dict(key),
                     "streak": fp.streak, "last": fp.last,
                     "band": list(fp.last_band) if fp.last_band else None,
                     "center": fp.center}
                    for (sig, key), fp in sorted(self._fps.items())
                    if fp.firing]

    # --- views ---

    def fingerprints_json(self) -> dict:
        """The versioned export the placement ranker
        consumes: one row per (signal, key) with the learned center,
        band, sample depth, and the spec that derives the figure."""
        specs = {s.name: s for s in self.signals}
        with self._lock:
            rows = []
            for (sig, key), fp in sorted(self._fps.items()):
                spec = specs.get(sig)
                band = (fp.band(spec.band_mad or self.cfg.band_mad,
                                spec.rel_floor)
                        if spec is not None else None)
                rows.append({
                    "signal": sig, "labels": dict(key),
                    "center": fp.center,
                    "band": list(band) if band else None,
                    "last": fp.last, "samples": fp.n,
                    "armed": fp.n >= ((spec.min_samples
                                       or self.cfg.min_samples)
                                      if spec else self.cfg.min_samples),
                    "firing": fp.firing, "streak": fp.streak,
                    "direction": spec.direction if spec else "low",
                    "unit_hint": sig,
                })
        return {"grammar": FINGERPRINT_GRAMMAR,
                "version": FINGERPRINT_VERSION,
                "signals": [s.to_json() for s in self.signals],
                "fingerprints": rows}

    def trends_json(self, family: str = "", resolution: str = "raw",
                    window: int | None = None) -> dict:
        """The ``GET /fleet/trends`` body: plane stats, the fingerprint
        export, the firing set, the bundle inventory, and — only when a
        ``?family=`` prefix narrows it — the actual ring data (the
        unfiltered reply stays a bounded inventory)."""
        body = {
            "enabled": True,
            "ticks": self.store.ticks(),
            "series_count": self.store.series_count(),
            "resolutions": {"raw": self.store.keep_raw,
                            **{f"{r}s": DEFAULT_KEEP_BY_RES[r]
                               for r in RESOLUTIONS}},
            "persist": self.persist_stats(),
            "regressions_total": self.regressions_total(),
            "firing": self.firing(),
            "fingerprints": self.fingerprints_json(),
            "bundles": (list_trend_bundles(self.bundle_dir)
                        if self.cfg.spool_dir else []),
        }
        if family:
            body["series"] = self.store.query(family=family,
                                              resolution=resolution,
                                              window=window)
        else:
            body["inventory"] = self.store.inventory()
        return body


def trend_rules() -> list:
    """The sentinel's bridge into the alert engine: one ``source="trend"``
    rule over the regression gauge.  It fires PER SERIES (every
    {signal, key} with value 1 is its own firing with its own labels),
    so one rule covers every fingerprint — installed before the operator
    loop, the budget_rules convention, and replaceable by name."""
    from iterative_cleaner_tpu_torch.fleet import alerts as fleet_alerts
    return [fleet_alerts.parse_rule({
        "name": "perf_regression",
        "source": "trend",
        "severity": "critical",
        "family": "ict_fleet_perf_regression",
        "predicate": {"op": "gt", "value": 0.0},
        "for_ticks": 1,
        "description": "a performance fingerprint has been outside its "
                       "learned EWMA+MAD band for K consecutive windows "
                       "(docs/OBSERVABILITY.md \"Performance trends & "
                       "regression sentinel\")"})]


# --- rendering (shared by the CLI one-shot and fleet_top) ---------------

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float], width: int = 24) -> str:
    """Unicode sparkline of the newest ``width`` values (constant range
    renders flat mid-height; empty input renders empty)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[3] * len(vals)
    span = hi - lo
    return "".join(
        _SPARK[min(int((v - lo) / span * (len(_SPARK) - 1)),
                   len(_SPARK) - 1)] for v in vals)


def _fmt(value) -> str:
    if value is None:
        return "-"
    value = float(value)
    if value != value:
        return "nan"
    if value == int(value) and abs(value) < 1e6:
        return str(int(value))
    return f"{value:.4g}"


def render_trends(body: dict) -> str:
    """The human view of one ``GET /fleet/trends`` body: the plane
    header, one fingerprint row per (signal, key) with its sparkline
    (when ring data is present) or its learned band, and the firing
    regressions — the fleet_top TREND section renders through this
    same function."""
    lines = [
        f"trends  ticks={_fmt(body.get('ticks'))}  "
        f"series={_fmt(body.get('series_count'))}  "
        f"regressions_total={_fmt(body.get('regressions_total'))}  "
        f"persists={_fmt((body.get('persist') or {}).get('persist_total'))}"]
    fps = (body.get("fingerprints") or {}).get("fingerprints") or []
    # Sparkline source: per-series raw rings when the reply carries them.
    rings: dict[str, list[float]] = {}
    for row in body.get("series") or []:
        label = ",".join(f"{k}={v}" for k, v in row.get("labels", ()))
        pts = row.get("points") or []
        rings[f"{row.get('sample')}{{{label}}}"] = [v for _t, v in pts]
    if fps:
        lines.append(f"{'SIGNAL':<18} {'SERIES':<24} {'LAST':>9} "
                     f"{'CENTER':>9} {'BAND':>19} {'N':>4} {'STATE':<8}")
        for fp in fps:
            labels = ",".join(f"{k}={v}"
                              for k, v in sorted(fp.get("labels",
                                                        {}).items()))
            band = fp.get("band")
            band_s = (f"[{_fmt(band[0])},{_fmt(band[1])}]"
                      if band else "-")
            state = ("FIRING" if fp.get("firing")
                     else "armed" if fp.get("armed") else "learning")
            lines.append(
                f"{fp.get('signal', '?'):<18} {labels or 'fleet':<24} "
                f"{_fmt(fp.get('last')):>9} {_fmt(fp.get('center')):>9} "
                f"{band_s:>19} {_fmt(fp.get('samples')):>4} {state:<8}")
    for name, vals in sorted(rings.items()):
        if vals:
            lines.append(f"  {name:<52} {sparkline(vals)}")
    firing = body.get("firing") or []
    if firing:
        lines.append("FIRING REGRESSIONS")
        for f in firing:
            labels = ",".join(f"{k}={v}"
                              for k, v in sorted(f.get("labels",
                                                       {}).items()))
            lines.append(f"  {f.get('signal')}  {labels or 'fleet'}  "
                         f"last={_fmt(f.get('last'))} "
                         f"center={_fmt(f.get('center'))} "
                         f"streak={_fmt(f.get('streak'))}")
    return "\n".join(lines)


def trends_main(argv: list[str] | None = None) -> int:
    """``ict-clean-torch trends``: one-shot fetch of a router's
    ``GET /fleet/trends`` — fingerprint table + sparklines (or the raw
    JSON / the fingerprint export for scripting).  Read-only."""
    p = argparse.ArgumentParser(
        prog="ict-clean-torch trends",
        description="Performance-trend snapshot off a fleet router's "
                    "GET /fleet/trends (fingerprints, bands, firing "
                    "regressions, per-series sparklines; read-only)")
    p.add_argument("--router", default="http://127.0.0.1:8790",
                   metavar="URL",
                   help="router base URL (default http://127.0.0.1:8790)")
    p.add_argument("--family", default="", metavar="PREFIX",
                   help="include ring data for series whose sample name "
                        "starts with PREFIX (default: inventory only)")
    p.add_argument("--resolution", default="raw",
                   choices=("raw",) + tuple(str(r) for r in RESOLUTIONS),
                   help="ring tier for --family data (default raw)")
    p.add_argument("--window", type=int, default=0, metavar="N",
                   help="newest N entries per series (0 = all retained)")
    p.add_argument("--json", action="store_true",
                   help="print the full GET /fleet/trends body as one "
                        "JSON line")
    p.add_argument("--fingerprints", action="store_true",
                   help="print ONLY the versioned fingerprint export "
                        "(the placement-ranker input) as one JSON line")
    p.add_argument("--timeout_s", type=float, default=10.0, metavar="S")
    args = p.parse_args(argv)
    base = args.router.rstrip("/")
    query = []
    if args.family:
        query.append(f"family={urllib.parse.quote(args.family)}")
        query.append(f"resolution={args.resolution}")
        if args.window > 0:
            query.append(f"window={args.window}")
    url = base + "/fleet/trends" + ("?" + "&".join(query) if query else "")
    try:
        with urllib.request.urlopen(url, timeout=args.timeout_s) as resp:
            body = json.load(resp)
    except (urllib.error.URLError, OSError, ValueError) as exc:
        print(json.dumps({"error": f"router unreachable: {exc}",
                          "router": base})
              if args.json or args.fingerprints
              else f"error: router unreachable at {base}: {exc}",
              file=sys.stdout if args.json or args.fingerprints
              else sys.stderr)
        return 1
    if args.fingerprints:
        print(json.dumps(body.get("fingerprints", {}), default=str))
        return 0
    if args.json:
        print(json.dumps(body, default=str))
        return 0
    print(render_trends(body))
    return 0


if __name__ == "__main__":
    raise SystemExit(trends_main())
