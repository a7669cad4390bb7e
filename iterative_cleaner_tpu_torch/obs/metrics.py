"""Prometheus text exposition over the :mod:`.tracing` registries.

A copy of ``iterative_cleaner_tpu/obs/metrics.py``: for the same registry
contents it renders byte for byte what the JAX package renders.

The serving daemon's ``/metrics`` renders this (the legacy raw-JSON
snapshot moved to ``/metrics.json``).  Three metric classes:

- **flat counters/gauges** — every registry entry verbatim under an
  ``ict_`` prefix, so the established internal names stay the operator
  vocabulary: ``ict_service_load_s`` (total seconds, counter),
  ``ict_service_load_n`` (count, counter), ``ict_service_load_err_n``
  (failures, counter), ``ict_service_load_max_s`` (worst single
  occurrence, gauge), plus the plain event counters
  (``ict_service_jobs_done`` …).  Every ``_s`` total has a matching
  ``_n`` count by construction (observe_phase writes both under one
  lock) — pinned by tests/test_observability.py.
- **histograms** — one family ``ict_phase_duration_seconds`` labeled by
  ``phase``, cumulative log2 buckets (``le`` bounds from
  tracing.HIST_BOUNDS) with ``_sum``/``_count`` taken from the same
  ``_s``/``_n`` counters.
- **labeled counters** — ``ict_<family>{label="..."}`` from
  tracing.count_labeled (compiles / compile seconds per ``shape_bucket``,
  jobs per ``route``, …).
- **gauges** — flat (``ict_host_rss_bytes``) and labeled
  (``ict_hbm_bytes_in_use{device=...}``,
  ``ict_route_hbm_peak_bytes{route=...}``,
  ``ict_executable_bytes_accessed{shape_bucket=...}``) from
  tracing.set_gauge / set_gauge_labeled / max_gauge_labeled — the
  memory/cost accounting of obs/memory.py.

This module also owns the *strict text-format parser* for the same
exposition (:func:`parse_exposition` / :class:`MetricFamily` /
:func:`render_exposition`): the fleet router's metrics federation
(fleet/obs.py) parses every replica scrape with it, and the round-trip is
exact — ``render_exposition(parse_exposition(text)) == text`` for
anything this module (or the router's registry renderer) produced — so
the parser, the renderer, and the grammar tests can never drift apart.
:func:`render_registries` is the one shared renderer for plain
``{(family, label_pairs) -> value}`` counter/gauge registries (the fleet
router's ``RouterMetrics.render`` delegates here).
"""

from __future__ import annotations

import dataclasses
import re

from iterative_cleaner_tpu_torch.obs import tracing

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(value: float) -> str:
    """Prometheus sample value: integral floats render as ints (bucket
    counts must not read as '3.0' in a strict parser), and the IEEE
    specials render as the exposition's ``+Inf``/``-Inf``/``NaN``
    spellings (repr's ``inf`` would fail the strict sample grammar —
    the capacity model's backlog-drain ETA is legitimately ``+Inf``
    while backlog exists with a zero observed service rate)."""
    value = float(value)
    if value != value:
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if value.is_integer():
        return str(int(value))
    return repr(value)


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(pairs) -> str:
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + inner + "}" if inner else ""


def render_prometheus() -> str:
    """One consistent scrape of every registry, Prometheus text format."""
    counters, labeled, gauges, labeled_gauges, hists = (
        tracing.registry_snapshot())
    lines: list[str] = []

    # --- phase latency histograms (cumulative buckets, label: phase) ---
    if hists:
        lines.append("# HELP ict_phase_duration_seconds per-phase latency, "
                     "fixed log2 buckets")
        lines.append("# TYPE ict_phase_duration_seconds histogram")
        for phase, buckets in hists.items():
            cum = 0
            for bound, n in zip(tracing.HIST_BOUNDS, buckets):
                cum += n
                lines.append(
                    "ict_phase_duration_seconds_bucket"
                    + _labels([("phase", phase), ("le", repr(bound))])
                    + f" {cum}")
            cum += buckets[-1]
            lines.append(
                "ict_phase_duration_seconds_bucket"
                + _labels([("phase", phase), ("le", "+Inf")]) + f" {cum}")
            lines.append(
                "ict_phase_duration_seconds_sum"
                + _labels([("phase", phase)])
                + f" {_fmt(counters.get(f'{phase}_s', 0.0))}")
            lines.append(
                "ict_phase_duration_seconds_count"
                + _labels([("phase", phase)])
                + f" {_fmt(counters.get(f'{phase}_n', 0.0))}")

    # --- flat counters / gauges, internal names preserved ---
    for name, value in counters.items():
        kind = "gauge" if name.endswith("_max_s") else "counter"
        lines.append(f"# TYPE ict_{name} {kind}")
        lines.append(f"ict_{name} {_fmt(value)}")

    # --- flat gauges (set_gauge: point-in-time facts like host RSS) ---
    for name, value in gauges.items():
        lines.append(f"# TYPE ict_{name} gauge")
        lines.append(f"ict_{name} {_fmt(value)}")

    # --- labeled counters (grouped per family for one TYPE line) ---
    seen_families: set[str] = set()
    for (family, label_pairs), value in labeled.items():
        if family not in seen_families:
            seen_families.add(family)
            lines.append(f"# TYPE ict_{family} counter")
        lines.append(f"ict_{family}{_labels(label_pairs)} {_fmt(value)}")

    # --- labeled gauges (device / route / shape_bucket memory views) ---
    seen_families.clear()
    for (family, label_pairs), value in labeled_gauges.items():
        if family not in seen_families:
            seen_families.add(family)
            lines.append(f"# TYPE ict_{family} gauge")
        lines.append(f"ict_{family}{_labels(label_pairs)} {_fmt(value)}")

    return "\n".join(lines) + "\n"


def render_registries(counters: dict, gauges: dict,
                      prefix: str = "ict_", hists: dict | None = None,
                      ) -> str:
    """Render plain ``{(family, ((label, value), ...)) -> float}`` counter
    and gauge registries as Prometheus text — the ONE implementation of
    the flat-registry exposition, shared by the fleet router's
    ``RouterMetrics`` (its registry is deliberately separate from the
    process-global one, but its *grammar* must not be a second
    implementation).

    ``hists`` is the optional histogram table:
    ``{(family, label_pairs) -> (bounds, per-bucket counts, sum)}`` with
    ``len(counts) == len(bounds) + 1`` (the trailing slot is the +Inf
    overflow).  Rendered as proper cumulative ``_bucket``/``_sum``/
    ``_count`` samples (the render_prometheus phase-histogram grammar),
    so :func:`bucket_cum` / :func:`quantile_from_cum` read them back —
    the fleet SLO plane's per-journey latency quantiles ride this."""
    lines: list[str] = []
    for kind, table in (("counter", counters), ("gauge", gauges)):
        seen: set[str] = set()
        for (family, label_pairs) in sorted(table):
            if family not in seen:
                seen.add(family)
                lines.append(f"# TYPE {prefix}{family} {kind}")
            lines.append(f"{prefix}{family}{_labels(label_pairs)} "
                         f"{_fmt(table[(family, label_pairs)])}")
    seen_h: set[str] = set()
    for (family, label_pairs) in sorted(hists or {}):
        bounds, buckets, total_sum = hists[(family, label_pairs)]
        if family not in seen_h:
            seen_h.add(family)
            lines.append(f"# TYPE {prefix}{family} histogram")
        cum = 0.0
        for bound, n in zip(bounds, buckets):
            cum += n
            lines.append(f"{prefix}{family}_bucket"
                         + _labels(tuple(label_pairs)
                                   + (("le", repr(float(bound))),))
                         + f" {_fmt(cum)}")
        cum += buckets[-1]
        lines.append(f"{prefix}{family}_bucket"
                     + _labels(tuple(label_pairs) + (("le", "+Inf"),))
                     + f" {_fmt(cum)}")
        lines.append(f"{prefix}{family}_sum{_labels(label_pairs)} "
                     f"{_fmt(total_sum)}")
        lines.append(f"{prefix}{family}_count{_labels(label_pairs)} "
                     f"{_fmt(cum)}")
    # Empty registries render as the empty exposition, not a lone "\n" —
    # a freshly started router's first scrape must still parse strictly.
    return "\n".join(lines) + "\n" if lines else ""


# --- the strict text-format parser (the federation's inbound half) ---

#: Metric/sample name and label-key grammars (the Prometheus data model);
#: values are the exposition's number grammar plus the +/-Inf / NaN
#: specials the renderer can emit via ``repr(float)``.
_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_HELP_RE = re.compile(rf"^# HELP ({_NAME_RE}) (.+)$")
_TYPE_RE = re.compile(
    rf"^# TYPE ({_NAME_RE}) (counter|gauge|histogram|summary|untyped)$")
_SAMPLE_RE = re.compile(
    rf"^({_NAME_RE})(?:\{{(.*)\}})? "
    r"(-?[0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?|[+-]?Inf|NaN)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

#: Histogram sample-name suffixes (`<family>_bucket` / `_sum` / `_count`).
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


@dataclasses.dataclass
class MetricFamily:
    """One parsed exposition family: the ``# TYPE`` header (``kind`` is
    None for samples that appeared without one), the optional ``# HELP``
    text, and the samples in file order — each ``(sample_name,
    label_pairs, raw_value)`` with the value kept as the exact source
    string so re-rendering round-trips byte-for-byte."""

    name: str
    kind: str | None = None
    help: str | None = None
    samples: list = dataclasses.field(default_factory=list)


def _unescape(value: str) -> str:
    """Inverse of :func:`_escape` (label-value backslash escapes)."""
    out: list[str] = []
    i = 0
    while i < len(value):
        if value[i] == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt in ("\\", '"'):
                out.append(nxt)
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(value[i])
        i += 1
    return "".join(out)


def _parse_label_pairs(raw: str) -> tuple:
    """Parse the inside of ``{...}`` strictly; raises ValueError on any
    residue the label grammar does not cover."""
    pairs: list[tuple[str, str]] = []
    pos = 0
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            raise ValueError(f"bad label syntax at {raw[pos:]!r}")
        pairs.append((m.group(1), _unescape(m.group(2))))
        pos = m.end()
        if pos < len(raw):
            if raw[pos] != ",":
                raise ValueError(f"bad label separator at {raw[pos:]!r}")
            pos += 1
    return tuple(pairs)


def _sample_family(name: str, current: MetricFamily | None) -> bool:
    """Whether a sample named ``name`` belongs to ``current`` (exact name,
    or a histogram-suffixed one for histogram families)."""
    if current is None:
        return False
    if name == current.name:
        return True
    return (current.kind == "histogram"
            and any(name == current.name + sfx for sfx in _HIST_SUFFIXES))


def parse_exposition(text: str) -> list[MetricFamily]:
    """Parse Prometheus text exposition strictly into families.

    Raises ValueError on any line outside the grammar — the parse IS the
    grammar check the fleet smoke and the federation tests rely on.
    Samples with no preceding ``# TYPE`` become kind-None families (the
    renderer then emits no TYPE line, preserving the round-trip)."""
    families: list[MetricFamily] = []
    pending_help: tuple[str, str] | None = None
    current: MetricFamily | None = None
    for line in text.splitlines():
        if not line:
            continue   # the format permits blank lines; none are emitted
        m = _HELP_RE.match(line)
        if m is not None:
            pending_help = (m.group(1), m.group(2))
            continue
        m = _TYPE_RE.match(line)
        if m is not None:
            current = MetricFamily(name=m.group(1), kind=m.group(2))
            if pending_help is not None and pending_help[0] == current.name:
                current.help = pending_help[1]
            pending_help = None
            families.append(current)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"bad exposition line: {line!r}")
        name, raw_labels, raw_value = m.group(1), m.group(2), m.group(3)
        labels = _parse_label_pairs(raw_labels) if raw_labels else ()
        if not _sample_family(name, current):
            current = MetricFamily(name=name, kind=None)
            families.append(current)
        current.samples.append((name, labels, raw_value))
    return families


def render_exposition(families: list[MetricFamily]) -> str:
    """Inverse of :func:`parse_exposition`: HELP line (when recorded),
    TYPE line (when typed), samples with raw values verbatim."""
    lines: list[str] = []
    for fam in families:
        if fam.help is not None:
            lines.append(f"# HELP {fam.name} {fam.help}")
        if fam.kind is not None:
            lines.append(f"# TYPE {fam.name} {fam.kind}")
        for name, labels, raw_value in fam.samples:
            lines.append(f"{name}{_labels(labels)} {raw_value}")
    return "\n".join(lines) + "\n" if lines else ""


def sample_value(raw: str) -> float:
    """Numeric value of a raw sample string (``+Inf``/``NaN`` included)."""
    if raw in ("+Inf", "Inf"):
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    return float(raw)


# --- shared histogram-bucket math (the one quantile estimator) ---
#
# The straggler detector (fleet/obs.py), the capacity model
# (fleet/capacity.py), and the alert engine's rate/quantile predicates
# (fleet/alerts.py) all estimate quantiles off the same fixed-bound
# cumulative bucket counts.  One estimator, one set of edge-case tests
# (tests/test_fleet_alerts.py) — a drifted second implementation would
# make two layers disagree about the same scrape.


def bucket_cum(families: list[MetricFamily], family: str,
               labels: dict[str, str] | None = None) -> dict[float, float]:
    """Cumulative bucket counts (``le`` bound -> count) for one histogram
    family out of a parsed scrape, filtered to samples whose label pairs
    contain every ``labels`` entry; empty when nothing matches.

    A grammar-valid scrape may still carry a foreign (non-numeric) ``le``
    bound — skipped, never raised, so the poll/alert threads that call
    this survive any replica's exposition."""
    want = dict(labels or {})
    out: dict[float, float] = {}
    for fam in families:
        if fam.name != family:
            continue
        for name, label_pairs, raw in fam.samples:
            if not name.endswith("_bucket"):
                continue
            d = dict(label_pairs)
            if any(d.get(k) != v for k, v in want.items()):
                continue
            try:
                out[sample_value(d.get("le", "+Inf"))] = sample_value(raw)
            except ValueError:
                continue
    return out


def quantile_from_cum(cum: dict[float, float], q: float) -> float | None:
    """Upper-bound quantile estimate from cumulative bucket counts: the
    smallest ``le`` whose cumulative count reaches ``q`` of the total.
    None when the histogram is empty or its total is non-positive."""
    if not cum:
        return None
    bounds = sorted(cum)
    total = cum[bounds[-1]]
    if total <= 0:
        return None
    target = q * total
    for bound in bounds:
        if cum[bound] >= target:
            return bound
    return bounds[-1]
