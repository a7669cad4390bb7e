"""SLI / error-budget plane for the fleet router (steering
half; the measurement half is the black-box prober in fleet/canary.py).

Port of ``iterative_cleaner_tpu/fleet/slo.py``.

The plane turns per-journey canary verdicts into the three classic SLIs
— **availability** (probe completed), **correctness** (mask
bit-identical to the stored numpy-oracle answer), **latency** (p50/p99
off the fixed log2 histogram bounds, the one shared quantile estimator
in obs/metrics.py) — and accounts declarative SLO objectives
(``--slo JOURNEY:TARGET:WINDOW_TICKS``) as an **error budget**: over the
objective window the allowed bad-event fraction is ``1 - target``, the
observed bad fraction divided by that allowance is the **burn rate**
(burn 1.0 = exactly on budget), and ``100 * (1 - burn)`` is the budget
remaining.  Two windows per objective feed the alert engine
(:func:`burn_rules`): the full objective window at a slow-burn threshold
(warning) and a window/8 fast window at a high-burn threshold
(critical) — the multiwindow shape that catches both a slow leak and a
cliff without paging on a single blip.

The ``admission`` journey is derived, not probed: the
``ict_fleet_slo_burn_total`` grant-wait counters fold into the same SLI
grammar (good = placements granted in time, bad = grant-wait burns);
the old family keeps rendering for one release.

The ledger is spool-persisted under ``<spool>/slo/`` with the campaign
store's crash discipline (``.part`` + atomic rename, tolerant reads,
part-sweep on rehydrate), so a router restart resumes the budget
accounting instead of refilling every budget to 100%.

Lock order: the plane owns one lock, acquired strictly AFTER the
router's and never while calling out to another plane; RouterMetrics is
a leaf registry with its own lock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass

from iterative_cleaner_tpu_torch.fleet import alerts as fleet_alerts
from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics
from iterative_cleaner_tpu_torch.obs import tracing

#: The probed user journeys (fleet/canary.py) plus the derived
#: ``admission`` journey (the grant-wait fold).
CANARY_JOURNEYS = ("fresh", "cache", "session", "campaign")
JOURNEYS = CANARY_JOURNEYS + ("admission",)

#: Multi-window burn-rate geometry: the fast window is the objective
#: window / 8 (floor 1 tick) and pages at 8x burn; the slow window is
#: the full objective window and warns at 2x burn.
FAST_DIVISOR = 8
FAST_BURN = 8.0
SLOW_BURN = 2.0

#: Availability window (ticks) for journeys WITHOUT a declared
#: objective — SLIs render for every journey, budgets only for
#: objectives.
DEFAULT_WINDOW_TICKS = 64

LEDGER_FILE = "ledger.json"

#: The plane's metric families (internal names; the renderer prefixes
#: ``ict_``).  Counters are monotonic per router life; gauges are
#: rebuilt whole each poll tick; the histogram carries per-journey
#: end-to-end latency on the fixed log2 bounds.
SLI_GAUGE_FAMILIES = ("sli_availability", "sli_correctness",
                      "sli_latency_p50_seconds", "sli_latency_p99_seconds",
                      "sli_error_budget_remaining_pct", "sli_burn_rate")
SLI_COUNTER_FAMILIES = ("sli_good_events_total", "sli_bad_events_total")
CANARY_COUNTER_FAMILIES = ("canary_probes_total",
                           "canary_mask_mismatches_total")
CANARY_HIST_FAMILY = "canary_journey_seconds"


@dataclass(frozen=True)
class SloObjective:
    """One declarative objective: ``journey`` must keep a good-event
    fraction of at least ``target`` over a rolling ``window_ticks``
    poll-tick window."""

    journey: str
    target: float
    window_ticks: int

    @property
    def fast_window(self) -> int:
        return max(1, self.window_ticks // FAST_DIVISOR)


def parse_slo_specs(specs) -> dict[str, SloObjective]:
    """``JOURNEY:TARGET:WINDOW_TICKS`` spec strings -> objectives dict;
    raises ValueError with an operator-actionable message on anything
    outside the grammar (the parse_tenant_specs convention)."""
    out: dict[str, SloObjective] = {}
    for spec in specs or ():
        parts = str(spec).split(":")
        if len(parts) != 3:
            raise ValueError(
                f"bad --slo spec {spec!r}: want JOURNEY:TARGET:WINDOW_TICKS "
                "(e.g. fresh:0.99:64)")
        journey = parts[0].strip()
        if journey not in JOURNEYS:
            raise ValueError(
                f"bad --slo spec {spec!r}: unknown journey {journey!r} "
                f"(want one of {JOURNEYS})")
        try:
            target = float(parts[1])
            window = int(parts[2])
        except ValueError:
            raise ValueError(
                f"bad --slo spec {spec!r}: TARGET must be a float in "
                "(0, 1], WINDOW_TICKS an int >= 1") from None
        if not 0.0 < target <= 1.0:
            raise ValueError(
                f"bad --slo spec {spec!r}: target must be in (0, 1], "
                f"got {target}")
        if window < 1:
            raise ValueError(
                f"bad --slo spec {spec!r}: window must be >= 1 tick, "
                f"got {window}")
        if journey in out:
            raise ValueError(
                f"duplicate --slo spec for journey {journey!r}")
        out[journey] = SloObjective(journey, target, window)
    return out


def burn_rules(objectives: dict[str, SloObjective],
               ) -> list["fleet_alerts.AlertRule"]:
    """Two burn-rate rules per objective over the router-computed
    ``ict_sli_burn_rate{journey, window}`` gauge (the
    fleet/costs.budget_rules registration pattern: built before the
    engine, an operator ``--alert_rule`` re-using a name replaces)."""
    rules = []
    for journey in sorted(objectives):
        obj = objectives[journey]
        rules.append(fleet_alerts.parse_rule({
            "name": f"slo_burn_fast:{journey}",
            "source": "slo",
            "severity": "critical",
            "family": "ict_sli_burn_rate",
            "labels": {"journey": journey, "window": "fast"},
            "predicate": {"op": "gt", "value": FAST_BURN},
            "for_ticks": 1,
            "description": f"journey {journey!r} is burning its error "
                           f"budget over {FAST_BURN:g}x the sustainable "
                           f"rate in the fast ({obj.fast_window}-tick) "
                           "window (docs/OBSERVABILITY.md \"Canary "
                           "probing & SLOs\")"}))
        rules.append(fleet_alerts.parse_rule({
            "name": f"slo_burn_slow:{journey}",
            "source": "slo",
            "severity": "warning",
            "family": "ict_sli_burn_rate",
            "labels": {"journey": journey, "window": "slow"},
            "predicate": {"op": "gt", "value": SLOW_BURN},
            "for_ticks": 1,
            "description": f"journey {journey!r} has burned over "
                           f"{SLOW_BURN:g}x its error budget across the "
                           f"full {obj.window_ticks}-tick objective "
                           "window"}))
    return rules


class SloPlane:
    """Per-journey SLI aggregation + the persisted error-budget ledger.

    Written by the router's poll thread (:meth:`note_admission`,
    :meth:`end_tick`) and the canary prober's round thread
    (:meth:`note_verdict`); read by the router's HTTP handler threads
    (:meth:`report`) and the autoscaler tick (:meth:`failing_journeys`).
    Own lock, acquired strictly after the router's, never while calling
    out (RouterMetrics is a leaf registry)."""

    def __init__(self, objectives: dict[str, SloObjective],
                 spool_dir: str, metrics=None, quiet: bool = True) -> None:
        self.objectives = dict(objectives)
        self.metrics = metrics
        self.quiet = quiet
        self.dir = os.path.join(spool_dir, "slo")
        os.makedirs(self.dir, exist_ok=True)
        keep = max([DEFAULT_WINDOW_TICKS]
                   + [o.window_ticks for o in self.objectives.values()])
        self._keep = keep
        # Reentrant: _observe_locked re-takes it so the histogram writes
        # stay lexically guarded (the _trim_idem_locked idiom).
        self._lock = threading.RLock()
        # Serializes ledger file writes (the poll thread's end_tick and
        # the prober thread's note_verdict both persist; two concurrent
        # writers truncating the same .part would tear it).
        self._io_lock = threading.Lock()
        self._tick = 0                   # ict: guarded-by(self._lock)
        # Cumulative per-journey totals (ledger-persisted, per SPOOL
        # life, not per process life).
        self._good: dict[str, float] = {}    # ict: guarded-by(self._lock)
        self._bad: dict[str, float] = {}     # ict: guarded-by(self._lock)
        self._probes: dict[str, float] = {}  # ict: guarded-by(self._lock)
        self._mask_bad: dict[str, float] = {}  # ict: guarded-by(self._lock)
        # Per-journey latency histogram: len(HIST_BOUNDS) buckets + the
        # +Inf overflow slot, plus the running sum (exposition grammar).
        self._hist: dict[str, list[float]] = {}  # ict: guarded-by(self._lock)
        self._hist_sum: dict[str, float] = {}    # ict: guarded-by(self._lock)
        # Rolling window ring: one [good, bad, probes, mask_bad] entry
        # per COMPLETED tick; _cur accumulates the open tick.
        self._ring: dict[str, deque] = {         # ict: guarded-by(self._lock)
            j: deque(maxlen=keep) for j in JOURNEYS}
        self._cur: dict[str, list] = {           # ict: guarded-by(self._lock)
            j: [0.0, 0.0, 0.0, 0.0] for j in JOURNEYS}
        self._last_verdicts: dict = {}           # ict: guarded-by(self._lock)
        # Previous admission counter totals (delta base for the fold).
        self._adm_prev = [0.0, 0.0]              # ict: guarded-by(self._lock)
        self._rehydrate()

    # --- event intake ---

    def note_verdict(self, verdict: dict) -> None:
        """One canary journey verdict from the prober: ``journey``,
        ``ok`` (availability), ``correct`` (mask bit-identity; None when
        the probe never produced a mask), ``latency_s``."""
        journey = str(verdict.get("journey", ""))
        if journey not in JOURNEYS:
            return
        ok = bool(verdict.get("ok"))
        correct = verdict.get("correct")
        latency = verdict.get("latency_s")
        with self._lock:
            cur = self._cur[journey]
            cur[2] += 1.0
            self._probes[journey] = self._probes.get(journey, 0.0) + 1.0
            if ok:
                cur[0] += 1.0
                self._good[journey] = self._good.get(journey, 0.0) + 1.0
            else:
                cur[1] += 1.0
                self._bad[journey] = self._bad.get(journey, 0.0) + 1.0
            if correct is False:
                cur[3] += 1.0
                self._mask_bad[journey] = (
                    self._mask_bad.get(journey, 0.0) + 1.0)
            if latency is not None:
                self._observe_locked(journey, float(latency))
            self._last_verdicts[journey] = {
                k: verdict.get(k) for k in
                ("journey", "ok", "correct", "latency_s", "error",
                 "trace_id", "hops", "ts")}
        m = self.metrics
        if m is not None:
            m.count("canary_probes_total",
                    {"journey": journey, "outcome": "ok" if ok else "fail"})
            if correct is False:
                m.count("canary_mask_mismatches_total", {"journey": journey})
            m.count("sli_good_events_total", {"journey": journey},
                    1.0 if ok else 0.0)
            m.count("sli_bad_events_total", {"journey": journey},
                    0.0 if ok else 1.0)
            if latency is not None:
                m.observe_hist(CANARY_HIST_FAMILY, {"journey": journey},
                               float(latency))
        self._persist()

    def note_admission(self, burned_total: float,
                       placed_total: float) -> None:
        """Fold the grant-wait counters into the ``admission``
        journey: this tick's placements that granted in time are good
        events, grant-wait burns are bad events.  Totals are cumulative
        router counters; the ledger differences them (and re-bases on a
        backwards jump — a restarted router's counters start at 0)."""
        with self._lock:
            prev_burn, prev_placed = self._adm_prev
            if burned_total < prev_burn or placed_total < prev_placed:
                prev_burn, prev_placed = 0.0, 0.0
            bad = max(burned_total - prev_burn, 0.0)
            good = max((placed_total - prev_placed) - bad, 0.0)
            self._adm_prev = [float(burned_total), float(placed_total)]
            cur = self._cur["admission"]
            cur[0] += good
            cur[1] += bad
            self._good["admission"] = self._good.get("admission", 0.0) + good
            self._bad["admission"] = self._bad.get("admission", 0.0) + bad
        m = self.metrics
        if m is not None and (good or bad):
            m.count("sli_good_events_total", {"journey": "admission"}, good)
            m.count("sli_bad_events_total", {"journey": "admission"}, bad)

    def end_tick(self) -> int:
        """Close the open tick: push accumulators into the rolling ring,
        advance the ledger tick, persist.  Called once per router poll
        tick (after the canary/admission intake)."""
        with self._lock:
            for j in JOURNEYS:
                self._ring[j].append(tuple(self._cur[j]))
                self._cur[j] = [0.0, 0.0, 0.0, 0.0]
            self._tick += 1
            tick = self._tick
        self._persist()
        return tick

    def _observe_locked(self, journey: str, latency_s: float) -> None:
        """Fold one latency into the journey's log2 histogram.  Takes
        the (reentrant) ledger lock itself so the writes stay lexically
        guarded; every caller already holds it."""
        with self._lock:
            buckets = self._hist.setdefault(
                journey, [0.0] * (len(tracing.HIST_BOUNDS) + 1))
            for i, bound in enumerate(tracing.HIST_BOUNDS):
                if latency_s <= bound:
                    buckets[i] += 1.0
                    break
            else:
                buckets[-1] += 1.0
            self._hist_sum[journey] = (self._hist_sum.get(journey, 0.0)
                                       + float(latency_s))

    # --- SLI / budget math (all pure reads of the ledger) ---

    @staticmethod
    def _window_sums(ring: deque, window: int) -> tuple:
        good = bad = probes = mask_bad = 0.0
        n = min(window, len(ring))
        for i in range(len(ring) - n, len(ring)):
            g, b, p, mb = ring[i]
            good += g
            bad += b
            probes += p
            mask_bad += mb
        return good, bad, probes, mask_bad

    @staticmethod
    def _burn(good: float, bad: float, target: float) -> float:
        events = good + bad
        if events <= 0 or bad <= 0:
            return 0.0
        bad_frac = bad / events
        allowance = 1.0 - target
        if allowance <= 0.0:
            return float("inf")
        return bad_frac / allowance

    def _journey_row_locked(self, journey: str) -> dict:
        obj = self.objectives.get(journey)
        window = obj.window_ticks if obj else DEFAULT_WINDOW_TICKS
        ring = self._ring[journey]
        good, bad, probes, mask_bad = self._window_sums(ring, window)
        # The open tick's events count too: a canary that just failed
        # must move the SLIs THIS tick, not next.
        cg, cb, cp, cmb = self._cur[journey]
        good, bad, probes, mask_bad = (good + cg, bad + cb, probes + cp,
                                       mask_bad + cmb)
        events = good + bad
        availability = good / events if events > 0 else 1.0
        correctness = ((probes - mask_bad) / probes) if probes > 0 else 1.0
        cum: dict[float, float] = {}
        running = 0.0
        hist = self._hist.get(journey)
        if hist is not None:
            for bound, n in zip(tracing.HIST_BOUNDS, hist):
                running += n
                cum[float(bound)] = running
            cum[float("inf")] = running + hist[-1]
        p50 = obs_metrics.quantile_from_cum(cum, 0.5)
        p99 = obs_metrics.quantile_from_cum(cum, 0.99)
        row = {
            "availability": round(availability, 6),
            "correctness": round(correctness, 6),
            "good": good, "bad": bad, "probes": probes,
            "mask_mismatches": mask_bad,
            "window_ticks": window,
            "latency_p50_s": p50, "latency_p99_s": p99,
        }
        if obj is not None:
            slow = self._burn(good, bad, obj.target)
            fg, fb, _fp, _fm = self._window_sums(ring, obj.fast_window)
            fast = self._burn(fg + cg, fb + cb, obj.target)
            remaining = (0.0 if slow == float("inf")
                         else max(0.0, 100.0 * (1.0 - slow)))
            row.update({
                "target": obj.target,
                "burn": {"fast": (fast if fast != float("inf") else "inf"),
                         "slow": (slow if slow != float("inf") else "inf")},
                "budget_remaining_pct": round(remaining, 3),
            })
        last = self._last_verdicts.get(journey)
        if last is not None:
            row["last_verdict"] = dict(last)
        return row

    def report(self) -> dict:
        """The ``GET /fleet/slo`` JSON body."""
        with self._lock:
            journeys = {j: self._journey_row_locked(j) for j in JOURNEYS}
            tick = self._tick
        failing = self.failing_journeys()
        return {
            "ts": round(time.time(), 3),
            "tick": tick,
            "objectives": {
                j: {"target": o.target, "window_ticks": o.window_ticks,
                    "fast_window_ticks": o.fast_window}
                for j, o in sorted(self.objectives.items())},
            "journeys": journeys,
            "failing_journeys": failing,
            "scale_down_veto": bool(failing),
        }

    def gauge_families(self) -> dict[str, dict[tuple, float]]:
        """The plane rendered for ``RouterMetrics.replace_gauge_family``
        — every journey always has a sample (availability/correctness
        default 1.0, budget 100%), the costs-plane pre-registration
        lesson: burn rules are gt thresholds and an absent series would
        freeze instead of resolving."""
        avail: dict[tuple, float] = {}
        correct: dict[tuple, float] = {}
        p50: dict[tuple, float] = {}
        p99: dict[tuple, float] = {}
        budget: dict[tuple, float] = {}
        burn: dict[tuple, float] = {}
        with self._lock:
            for j in JOURNEYS:
                row = self._journey_row_locked(j)
                key = (("journey", j),)
                avail[key] = row["availability"]
                correct[key] = row["correctness"]
                p50[key] = float(row["latency_p50_s"] or 0.0)
                p99[key] = float(row["latency_p99_s"] or 0.0)
                budget[key] = float(row.get("budget_remaining_pct", 100.0))
                b = row.get("burn") or {"fast": 0.0, "slow": 0.0}
                for win in ("fast", "slow"):
                    v = b[win]
                    burn[(("journey", j), ("window", win))] = (
                        float("inf") if v == "inf" else float(v))
        return {
            "sli_availability": avail,
            "sli_correctness": correct,
            "sli_latency_p50_seconds": p50,
            "sli_latency_p99_seconds": p99,
            "sli_error_budget_remaining_pct": budget,
            "sli_burn_rate": burn,
        }

    def min_budget_remaining(self) -> float | None:
        """The minimum ``budget_remaining_pct`` across declared
        objectives (None when no --slo objective exists) — the budget
        state handed to the autoscaler as a decision input signal."""
        if not self.objectives:
            return None
        with self._lock:
            vals = [self._journey_row_locked(j).get("budget_remaining_pct")
                    for j in self.objectives]
        vals = [float(v) for v in vals if v is not None]
        return min(vals) if vals else None

    def failing_journeys(self) -> list[str]:
        """Canary journeys whose LATEST verdict failed (unavailable or
        mask-mismatched) — the autoscaler's scale-down veto input."""
        out = []
        with self._lock:
            for j in CANARY_JOURNEYS:
                last = self._last_verdicts.get(j)
                if last is None:
                    continue
                if not last.get("ok") or last.get("correct") is False:
                    out.append(j)
        return out

    # --- spool persistence (the campaign store discipline) ---

    def _persist(self) -> None:
        with self._lock:
            body = {
                "version": 1,
                "tick": self._tick,
                "adm_prev": list(self._adm_prev),
                "journeys": {
                    j: {
                        "good": self._good.get(j, 0.0),
                        "bad": self._bad.get(j, 0.0),
                        "probes": self._probes.get(j, 0.0),
                        "mask_bad": self._mask_bad.get(j, 0.0),
                        "hist": list(self._hist.get(j, [])),
                        "hist_sum": self._hist_sum.get(j, 0.0),
                        "ring": [list(e) for e in self._ring[j]],
                        "last_verdict": self._last_verdicts.get(j),
                    } for j in JOURNEYS},
            }
        path = os.path.join(self.dir, LEDGER_FILE)
        part = path + ".part"
        with self._io_lock:
            try:
                with open(part, "w") as fh:
                    json.dump(body, fh)
                os.replace(part, path)
            except OSError:
                # Best-effort durability: a full disk must not take the
                # poll loop down; the in-memory ledger stays
                # authoritative.
                try:
                    os.unlink(part)
                except OSError:
                    pass

    def _rehydrate(self) -> None:
        # Sweep orphaned .part files from a crashed writer first.
        try:
            for name in os.listdir(self.dir):
                if name.endswith(".part"):
                    try:
                        os.unlink(os.path.join(self.dir, name))
                    except OSError:
                        pass
        except OSError:
            return
        path = os.path.join(self.dir, LEDGER_FILE)
        try:
            with open(path) as fh:
                body = json.load(fh)
        except (OSError, ValueError):
            return
        if not isinstance(body, dict):
            return
        nbuckets = len(tracing.HIST_BOUNDS) + 1
        with self._lock:
            try:
                self._tick = int(body.get("tick", 0))
                prev = body.get("adm_prev") or [0.0, 0.0]
                self._adm_prev = [float(prev[0]), float(prev[1])]
                for j, rec in (body.get("journeys") or {}).items():
                    if j not in JOURNEYS or not isinstance(rec, dict):
                        continue
                    self._good[j] = float(rec.get("good", 0.0))
                    self._bad[j] = float(rec.get("bad", 0.0))
                    self._probes[j] = float(rec.get("probes", 0.0))
                    self._mask_bad[j] = float(rec.get("mask_bad", 0.0))
                    hist = [float(v) for v in rec.get("hist") or []]
                    if len(hist) == nbuckets:
                        self._hist[j] = hist
                        self._hist_sum[j] = float(rec.get("hist_sum", 0.0))
                    for entry in rec.get("ring") or []:
                        if isinstance(entry, list) and len(entry) == 4:
                            self._ring[j].append(
                                tuple(float(v) for v in entry))
                    last = rec.get("last_verdict")
                    if isinstance(last, dict):
                        self._last_verdicts[j] = last
            except (TypeError, ValueError):
                # A torn or foreign ledger restarts the accounting clean
                # rather than poisoning the poll loop.
                self._tick = 0
                self._adm_prev = [0.0, 0.0]
