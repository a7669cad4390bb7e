"""Federated metrics history: the bounded time axis under the fleet view.

Port of ``iterative_cleaner_tpu/fleet/history.py``.

``GET /fleet/metrics`` is one instant — the ScrapeCache keeps only each
replica's last good scrape, so "is this figure *rising*" was an operator
holding two terminal scrollbacks.  :class:`MetricsHistory` closes that
gap with zero new scrape traffic: once per poll tick the router parses
the very exposition it already serves (router registry + per-replica
re-labeled series + merged ``ict_fleet_*`` families, all from the ONE
cache snapshot) and appends the parsed families to a bounded ring of
tick records.

Two consumers:

- ``GET /fleet/metrics/history`` serves the ring as strict JSON (sample
  values stay the exposition's raw strings — ``+Inf``/``NaN`` spellings
  included — so the reply is valid JSON *and* each tick re-renders
  byte-exact through ``obs.metrics.render_exposition``, the
  ``/fleet/capacity`` IEEE-specials discipline);
- the alert engine (fleet/alerts.py) evaluates its rule predicates over
  :meth:`series` / :meth:`cum_series` windows — threshold, delta/rate
  over N ticks, absence, histogram quantiles — all off this ring, never
  off a fresh scrape.

Memory is bounded by construction: ``keep`` ticks, each a parsed-family
list the size of one exposition.  Samples are indexed by name at append
time so per-tick rule evaluation is a dict lookup, not a re-scan of the
whole window's text.
"""

from __future__ import annotations

import collections
import threading
import time

from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics
from iterative_cleaner_tpu_torch.obs.metrics import MetricFamily

#: Poll ticks retained by default — at the default 1 s poll cadence,
#: about two minutes of history: enough for every default alert window
#: (<= 8 ticks) with headroom for an operator's `?ticks=` reads.
DEFAULT_KEEP = 128


def family_to_json(fam: MetricFamily) -> dict:
    """One parsed family as strict JSON: raw sample values stay strings
    (``+Inf``/``NaN`` keep their exposition spellings), label pairs stay
    ordered — :func:`family_from_json` inverts losslessly, so a stored
    tick re-renders byte-exact."""
    return {
        "name": fam.name,
        "kind": fam.kind,
        "help": fam.help,
        "samples": [[name, [[k, v] for k, v in labels], raw]
                    for name, labels, raw in fam.samples],
    }


def family_from_json(obj: dict) -> MetricFamily:
    """Inverse of :func:`family_to_json`."""
    fam = MetricFamily(name=str(obj["name"]), kind=obj.get("kind"),
                       help=obj.get("help"))
    fam.samples = [
        (name, tuple((str(k), str(v)) for k, v in labels), raw)
        for name, labels, raw in obj.get("samples", [])]
    return fam


def _index(families: list[MetricFamily]) -> dict[str, list]:
    """``sample name -> [(label_pairs, float value), ...]`` for one tick —
    built once at append time so predicate evaluation never re-walks the
    family lists.  Unparseable values cannot occur in samples that came
    through the strict parser; foreign input (family_from_json on
    operator JSON) is still skipped, not raised."""
    out: dict[str, list] = {}
    for fam in families:
        for name, labels, raw in fam.samples:
            try:
                value = obs_metrics.sample_value(raw)
            except ValueError:
                continue
            out.setdefault(name, []).append((labels, value))
    return out


def _matches(label_pairs: tuple, want: tuple) -> bool:
    """Whether a sample's label pairs contain every selector pair."""
    if not want:
        return True
    d = dict(label_pairs)
    return all(d.get(k) == v for k, v in want)


class MetricsHistory:
    """Bounded ring of per-poll-tick parsed expositions, written by the
    router's poll thread (:meth:`append`, once per tick) and read by its
    HTTP handler threads and the alert engine.  Own lock, acquired
    strictly AFTER the router's RLock (the lock-order discipline) and never
    while calling out; tick records are immutable once appended, so
    snapshot reads hand out the record dicts themselves."""

    def __init__(self, keep: int = DEFAULT_KEEP) -> None:
        self.keep = max(int(keep), 1)
        self._lock = threading.Lock()
        self._ticks: collections.deque = collections.deque(maxlen=self.keep)  # ict: guarded-by(self._lock)
        self._seq = 0  # ict: guarded-by(self._lock)

    def append(self, families: list[MetricFamily]) -> dict:
        """Record one poll tick's parsed exposition; returns the record.
        The record (families included) is treated as immutable from here
        on — readers receive it without copying."""
        rec = {
            "families": families,
            "by_name": _index(families),
            "ts": round(time.time(), 3),
            "ts_mono": time.monotonic(),
        }
        with self._lock:
            rec["tick"] = self._seq
            self._seq += 1
            self._ticks.append(rec)
        return rec

    def size(self) -> int:
        with self._lock:
            return len(self._ticks)

    def last_tick(self) -> int:
        """Sequence number of the newest record (-1 when empty)."""
        with self._lock:
            return self._ticks[-1]["tick"] if self._ticks else -1

    def window(self, ticks: int | None = None) -> list[dict]:
        """The newest ``ticks`` records oldest-first (all when None;
        empty for ticks <= 0 — a negative slice bound must not invert
        the clip into 'serve everything')."""
        with self._lock:
            recs = list(self._ticks)
        if ticks is not None:
            n = int(ticks)
            recs = recs[-n:] if n > 0 else []
        return recs

    # --- series extraction (the alert predicates' input) ---

    def series(self, family: str, labels: tuple = (),
               window: int | None = None) -> dict[tuple, list[tuple]]:
        """``{full label pairs -> [(tick, ts_mono, value), ...]}`` for
        every sample named ``family`` whose labels contain the selector
        subset, over the newest ``window`` ticks (oldest-first)."""
        out: dict[tuple, list[tuple]] = {}
        for rec in self.window(window):
            for label_pairs, value in rec["by_name"].get(family, ()):
                if _matches(label_pairs, labels):
                    out.setdefault(label_pairs, []).append(
                        (rec["tick"], rec["ts_mono"], value))
        return out

    def cum_series(self, family: str, labels: tuple = (),
                   window: int | None = None) -> dict[tuple, list[tuple]]:
        """Histogram view of :meth:`series`: ``{non-le label pairs ->
        [(tick, ts_mono, {le -> cum count}), ...]}`` for ``family``'s
        ``_bucket`` samples — the shape `obs.metrics.quantile_from_cum`
        consumes after windowed differencing."""
        out: dict[tuple, list[tuple]] = {}
        bucket_name = family + "_bucket"
        for rec in self.window(window):
            per_key: dict[tuple, dict[float, float]] = {}
            for label_pairs, value in rec["by_name"].get(bucket_name, ()):
                if not _matches(label_pairs, labels):
                    continue
                d = dict(label_pairs)
                raw_le = d.pop("le", "+Inf")
                try:
                    le = obs_metrics.sample_value(raw_le)
                except ValueError:
                    continue
                key = tuple(sorted(d.items()))
                per_key.setdefault(key, {})[le] = value
            for key, cum in per_key.items():
                out.setdefault(key, []).append(
                    (rec["tick"], rec["ts_mono"], cum))
        return out

    # --- the HTTP view ---

    def to_json(self, ticks: int | None = None,
                families: tuple = ()) -> dict:
        """The ``GET /fleet/metrics/history`` body: newest ``ticks``
        records oldest-first, each tick's families in the lossless
        strict-JSON shape (:func:`family_to_json`).  ``families`` is an
        optional tuple of family-name PREFIXES (the ``?families=``
        filter): each tick keeps only matching families, in original
        order, so a filtered tick still re-renders byte-exact for the
        families it carries — same grammar, smaller wire cost."""
        recs = self.window(ticks)
        prefixes = tuple(p for p in families if p)

        def keep_fam(fam: MetricFamily) -> bool:
            return (not prefixes
                    or any(fam.name.startswith(p) for p in prefixes))

        return {
            "keep": self.keep,
            "ticks": [{
                "tick": rec["tick"],
                "ts": rec["ts"],
                "families": [family_to_json(f) for f in rec["families"]
                             if keep_fam(f)],
            } for rec in recs],
        }
