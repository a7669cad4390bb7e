"""Declarative SLO alerting over the federated metrics history.

Port of ``iterative_cleaner_tpu/fleet/alerts.py``.

The observability stack *exports* everything — merged ``ict_fleet_*``
families, capacity gauges, audit divergences, scrape staleness — but
until this module nothing *watched* it: the operator contract was "read
the exposition yourself".  This is the closing of the
measurement-to-detection loop (the Pipeline-Collector pattern's end
state, arXiv:1807.05733): a small, evaluated rule grammar over the
:class:`~.history.MetricsHistory` ring, run once per poll tick on the
snapshot the router already took — **no per-rule scrapes, ever**.

A rule is ``(name, severity, selector, predicate, for_ticks)``:

- **selector** — a sample/family name plus an optional label subset;
  every distinct label set matching the selector is its own *series*,
  and alerts fire per series (``scrape_stale`` fires per replica);
- **predicate** — one of the grammar's ops over the history window:
  ``gt/ge/lt/le/eq/ne`` (latest value vs a threshold), ``delta_gt`` /
  ``rate_gt`` (change / per-second rate across ``window`` ticks),
  ``absent`` (no matching sample for ``window`` ticks — the staleness
  shape), ``quantile_gt`` (upper-bound bucket quantile of a histogram's
  windowed bucket deltas, via the ONE shared estimator
  ``obs.metrics.quantile_from_cum``);
- **for_ticks** — hysteresis: the predicate must hold for K consecutive
  ticks before the alert fires (the StragglerDetector K-consecutive-
  polls discipline, generalized); ONE in-bounds tick resolves it.  A
  series *missing* from a tick (failed scrape, lazily-registered
  counter) yields no verdict and freezes the state — a degrading
  replica must not resolve its own alert by timing out its scrape
  (``absent`` inverts this: missing IS the signal).

Lifecycle is a firing -> resolved state machine per (rule, series) with
dedup by construction (a firing series cannot re-fire until it
resolves).  Every transition is the router's to fan out: events +
flight ring, ``ict_fleet_alerts_total{rule,severity}`` /
``ict_fleet_alerts_firing{rule}``, an on-disk bundle per firing
(manifest carries the rule, the evaluated samples, and the history
window that fired it — every alert reconstructible from disk), and the
optional webhook/command sinks (:class:`AlertSinks`, full-jitter
retries so N routers recovering together don't herd one receiver).

The :func:`default_rule_pack` encodes the invariants the stack already
documents — audit divergence movement, scrape staleness, backlog ETA
with the autoscaler off, torch->numpy demotion, spool disk headroom,
compile-cache thrash (docs/OBSERVABILITY.md "Alerting & history").
"""

from __future__ import annotations

import collections
import json
import operator
import os
import queue
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
import uuid
from dataclasses import dataclass, field, replace

from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics
from iterative_cleaner_tpu_torch.utils import backoff

SEVERITIES = ("info", "warning", "critical")

#: Ops and the shape of their predicate dicts (beyond "op" itself).
#: Threshold ops compare the latest tick; windowed ops look back
#: ``window`` ticks; ``quantile_gt`` adds the quantile ``q``.
THRESHOLD_OPS = {"gt": operator.gt, "ge": operator.ge, "lt": operator.lt,
                 "le": operator.le, "eq": operator.eq, "ne": operator.ne}
WINDOW_OPS = ("delta_gt", "rate_gt", "absent", "quantile_gt")

#: Alert bundles kept per directory (oldest swept) — the
#: flight.MAX_DUMPS_KEPT rationale: a flapping rule must not fill the
#: router spool with one bundle per firing.
MAX_ALERT_BUNDLES_KEPT = 20

#: Firing/resolved transitions remembered for ``GET /fleet/alerts``.
MAX_RECENT_TRANSITIONS = 256

_NAME_RE = re.compile(r"^[A-Za-z0-9_.:-]{1,128}$")
_FAMILY_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


@dataclass(frozen=True)
class AlertRule:
    """One declarative rule.  ``labels`` is the selector's label subset
    as sorted pairs; ``predicate`` is the validated grammar dict."""

    name: str
    severity: str
    family: str
    predicate: dict
    for_ticks: int = 1
    labels: tuple = ()
    description: str = ""
    # Registration provenance, for the rules table: "default" (the
    # built-in pack), "budget" (fleet/costs.budget_rules), "slo"
    # (fleet/slo.burn_rules), or "operator" (--alert_rule / JSON file).
    source: str = "operator"

    def to_json(self) -> dict:
        return {"name": self.name, "severity": self.severity,
                "family": self.family, "labels": dict(self.labels),
                "predicate": dict(self.predicate),
                "for_ticks": self.for_ticks,
                "description": self.description,
                "source": self.source}


def parse_rule(spec: dict) -> AlertRule:
    """Validate one rule spec (the ``--alert_rule`` JSON shape); raises
    ValueError with an operator-actionable message on anything outside
    the grammar."""
    if not isinstance(spec, dict):
        raise ValueError(f"alert rule must be a JSON object, got "
                         f"{type(spec).__name__}")
    name = str(spec.get("name", ""))
    if not _NAME_RE.match(name):
        raise ValueError(f"bad alert rule name {name!r} (want "
                         "[A-Za-z0-9_.:-]{1,128})")
    severity = str(spec.get("severity", "warning"))
    if severity not in SEVERITIES:
        raise ValueError(f"rule {name!r}: bad severity {severity!r} "
                         f"(want one of {SEVERITIES})")
    family = str(spec.get("family", ""))
    if not _FAMILY_RE.match(family):
        raise ValueError(f"rule {name!r}: bad selector family {family!r}")
    labels = spec.get("labels", {})
    if not isinstance(labels, dict):
        raise ValueError(f"rule {name!r}: labels must be an object")
    pred = spec.get("predicate")
    if not isinstance(pred, dict) or "op" not in pred:
        raise ValueError(f"rule {name!r}: predicate must be an object "
                         'with an "op"')
    op = str(pred["op"])
    if op not in THRESHOLD_OPS and op not in WINDOW_OPS:
        raise ValueError(
            f"rule {name!r}: unknown predicate op {op!r} (want one of "
            f"{sorted(THRESHOLD_OPS) + list(WINDOW_OPS)})")
    clean: dict = {"op": op}
    if op != "absent":
        try:
            clean["value"] = float(pred["value"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"rule {name!r}: predicate op {op!r} needs a "
                             'numeric "value"') from None
    if op in WINDOW_OPS:
        try:
            clean["window"] = int(pred.get("window", 1))
        except (TypeError, ValueError):
            raise ValueError(f"rule {name!r}: predicate window must be an "
                             "int >= 1") from None
        if clean["window"] < 1:
            raise ValueError(f"rule {name!r}: predicate window must be "
                             f">= 1, got {clean['window']}")
    if op == "quantile_gt":
        try:
            clean["q"] = float(pred["q"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"rule {name!r}: quantile_gt needs a numeric "
                             '"q" in (0, 1]') from None
        if not 0.0 < clean["q"] <= 1.0:
            raise ValueError(f"rule {name!r}: q must be in (0, 1], got "
                             f"{clean['q']}")
    try:
        for_ticks = int(spec.get("for_ticks", 1))
    except (TypeError, ValueError):
        raise ValueError(f"rule {name!r}: for_ticks must be an int >= 1"
                         ) from None
    if for_ticks < 1:
        raise ValueError(f"rule {name!r}: for_ticks must be >= 1, got "
                         f"{for_ticks}")
    return AlertRule(
        name=name, severity=severity, family=family, predicate=clean,
        for_ticks=for_ticks,
        labels=tuple(sorted((str(k), str(v)) for k, v in labels.items())),
        description=str(spec.get("description", "")),
        source=str(spec.get("source", "operator")))


def default_rule_pack(poll_interval_s: float = 1.0,
                      scale_up_eta_s: float = 10.0,
                      autoscale: str = "off") -> list[AlertRule]:
    """The invariants the stack already documents, as rules.

    Each watches a family the fleet view exports today — per-replica
    re-labeled series where attribution matters, merged/router families
    where the fleet total is the fact.  ``backlog_behind_unscaled`` only
    exists while the autoscaler is off: with ``advise``/``act`` on, the
    scaler itself owns that signal (fleet_scale_events_total)."""
    rules = [
        # gt-0 thresholds, NOT delta predicates, deliberately: a delta
        # rule would never see the counter's first appearance (no prior
        # sample to difference against) — and the nonzero state IS the
        # fact that matters (wrong masks were served / the replica runs
        # demoted).  Both resolve when the replica restarts clean: the
        # daemon PRE-REGISTERS these counters at 0 (CleaningService.
        # start), so a restarted replica exports an explicit 0 instead
        # of a missing series freeze-on-missing would pin forever.
        parse_rule({
            "name": "audit_divergence", "severity": "critical",
            "family": "ict_audit_divergences",
            "predicate": {"op": "gt", "value": 0},
            "for_ticks": 1,
            "description": "a replica's shadow-oracle audit divergence "
                           "counter is nonzero — it has served wrong "
                           "masks this life"}),
        parse_rule({
            "name": "backend_demoted", "severity": "critical",
            "family": "ict_service_backend_demotions",
            "predicate": {"op": "gt", "value": 0},
            "for_ticks": 1,
            "description": "a replica demoted torch -> numpy (oracle "
                           "mode): correct but slow — the worker "
                           "fault ladder's top rung tripped"}),
        parse_rule({
            "name": "scrape_stale", "severity": "warning",
            "family": "ict_fleet_scrape_age_seconds",
            "predicate": {"op": "gt",
                          "value": 3.0 * max(poll_interval_s, 0.001)},
            "for_ticks": 2,
            "description": "a replica's /metrics scrape is older than 3x "
                           "the poll interval — its fleet view is stale"}),
        parse_rule({
            "name": "spool_disk_low", "severity": "warning",
            "family": "ict_spool_disk_free_bytes",
            "predicate": {"op": "lt", "value": float(1 << 30)},
            "for_ticks": 2,
            "description": "a replica's spool volume is under 1 GiB free "
                           "— manifest writes are about to start failing"}),
        parse_rule({
            "name": "compile_cache_thrash", "severity": "warning",
            "family": "ict_compile_cache_key_misses",
            "predicate": {"op": "rate_gt", "value": 0.5, "window": 8},
            "for_ticks": 3,
            "description": "sustained compile-cache key misses — the "
                           "persistent XLA cache is thrashing (undersized "
                           "ICT_COMPILE_CACHE_MAX_MB, or unbucketed "
                           "shapes)"}),
    ]
    if autoscale == "off":
        rules.append(parse_rule({
            "name": "backlog_behind_unscaled", "severity": "warning",
            "family": "ict_fleet_backlog_eta_seconds",
            "predicate": {"op": "gt", "value": float(scale_up_eta_s)},
            "for_ticks": 3,
            "description": "backlog-drain ETA sits above the scale-up "
                           "threshold while --autoscale is off — the "
                           "fleet is behind and nothing will grow it"}))
    return [replace(r, source="default") for r in rules]


@dataclass
class _SeriesState:
    """Per-(rule, series) lifecycle record; mutated only under the
    engine's lock."""

    consecutive: int = 0
    firing: bool = False
    since_tick: int = -1
    since_ts: float = 0.0
    last_value: float | None = None
    samples: list = field(default_factory=list)


class AlertEngine:
    """The firing -> resolved state machine over every (rule, series).

    Written by the router's poll thread (:meth:`evaluate`, once per
    tick) and read by its HTTP handler threads (:meth:`firing`,
    :meth:`recent`, :meth:`rules_table`).  Own lock, acquired strictly
    AFTER the router's RLock and never while calling out."""

    def __init__(self, rules: list[AlertRule],
                 history_ticks: int | None = None) -> None:
        names = [r.name for r in rules]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate alert rule names: {sorted(dupes)}")
        if history_ticks is not None:
            # Fail FAST on a rule the ring can never satisfy: a window
            # needing more ticks than --history_ticks keeps would freeze
            # at "no verdict" forever — the operator would believe the
            # condition is monitored while the rule silently never fires.
            for rule in rules:
                op = rule.predicate.get("op")
                window = int(rule.predicate.get("window", 1))
                need = window if op == "absent" else (
                    window + 1 if op in WINDOW_OPS else 1)
                if need > history_ticks:
                    raise ValueError(
                        f"alert rule {rule.name!r} needs {need} history "
                        f"ticks (op {op!r}, window {window}) but only "
                        f"{history_ticks} are retained — raise "
                        f"--history_ticks or shrink the window")
        self.rules = tuple(rules)
        self._lock = threading.Lock()
        self._states: dict[tuple, _SeriesState] = {}  # ict: guarded-by(self._lock)
        self._recent = collections.deque(maxlen=MAX_RECENT_TRANSITIONS)  # ict: guarded-by(self._lock)

    # --- predicate evaluation (pure reads of the history) ---

    @staticmethod
    def _verdicts(rule: AlertRule, history) -> dict[tuple, tuple]:
        """``{series key -> (verdict, value, samples)}`` for one rule on
        the current history.  verdict None = not enough data (state
        freezes); samples are the windowed points the verdict read."""
        pred = rule.predicate
        op = pred["op"]
        if op == "absent":
            window = pred["window"]
            pts = history.series(rule.family, rule.labels, window=window)
            present = any(pts.values())
            # Absence needs a full window of recorded ticks before it can
            # claim the series is gone (a freshly started router has no
            # history, not a missing replica).
            if history.size() < window:
                return {rule.labels: (None, None, [])}
            return {rule.labels: (not present, None,
                                  [{"ticks_checked": window,
                                    "matches": sum(len(v)
                                                   for v in pts.values())}])}
        if op == "quantile_gt":
            window = pred["window"]
            out = {}
            for key, seq in history.cum_series(
                    rule.family, rule.labels, window=window + 1).items():
                if len(seq) < window + 1:   # same strictness as delta/rate
                    out[key] = (None, None, [])
                    continue
                _t0, _m0, first = seq[0]
                _t1, _m1, last = seq[-1]
                delta = {le: max(n - first.get(le, 0.0), 0.0)
                         for le, n in last.items()}
                q = obs_metrics.quantile_from_cum(delta, pred["q"])
                if q is None:
                    out[key] = (None, None, [])
                    continue
                out[key] = (q > pred["value"], q,
                            [{"tick": t, "cum_total": max(c.values())
                              if c else 0.0} for t, _m, c in seq])
            return out
        if op in ("delta_gt", "rate_gt"):
            window = pred["window"]
            out = {}
            for key, seq in history.series(
                    rule.family, rule.labels, window=window + 1).items():
                if len(seq) < window + 1:
                    out[key] = (None, None, [])
                    continue
                t0, m0, v0 = seq[0]
                t1, m1, v1 = seq[-1]
                delta = v1 - v0
                if op == "rate_gt":
                    dt = m1 - m0
                    value = delta / dt if dt > 0 else 0.0
                else:
                    value = delta
                out[key] = (value > pred["value"], value,
                            [{"tick": t, "value": v} for t, _m, v in seq])
            return out
        # threshold ops: the latest tick only
        cmp = THRESHOLD_OPS[op]
        out = {}
        last = history.last_tick()
        for key, seq in history.series(
                rule.family, rule.labels, window=1).items():
            tick, _mono, value = seq[-1]
            if tick != last:
                out[key] = (None, None, [])
                continue
            out[key] = (cmp(value, pred["value"]), value,
                        [{"tick": tick, "value": value}])
        return out

    # --- the per-tick fold ---

    def evaluate(self, history) -> dict:
        """One tick's verdict: ``{"fired": [...], "resolved": [...],
        "firing": [...]}`` — alert dicts, ready for the router's fan-out.
        Dedup by construction: a firing (rule, series) cannot re-fire
        until one in-bounds tick resolves it; a series with no verdict
        this tick (missing sample, short window) freezes in place."""
        tick = history.last_tick()
        now = round(time.time(), 6)
        fired: list[dict] = []
        resolved: list[dict] = []
        per_rule = [(rule, self._verdicts(rule, history))
                    for rule in self.rules]
        with self._lock:
            for rule, verdicts in per_rule:
                for series_key, (verdict, value, samples) in \
                        verdicts.items():
                    key = (rule.name, series_key)
                    st = self._states.get(key)
                    if st is None:
                        st = self._states[key] = _SeriesState()
                    if verdict is None:
                        continue   # frozen: no data is not a transition
                    if verdict:
                        st.consecutive += 1
                        st.last_value = value
                        st.samples = samples
                        if (st.consecutive >= rule.for_ticks
                                and not st.firing):
                            st.firing = True
                            st.since_tick = tick
                            st.since_ts = now
                            fired.append(self._alert_dict(
                                rule, series_key, st, tick, now,
                                state="firing"))
                    else:
                        st.consecutive = 0
                        st.last_value = value
                        if st.firing:
                            st.firing = False
                            resolved.append(self._alert_dict(
                                rule, series_key, st, tick, now,
                                state="resolved", samples=samples))
            for rec in fired + resolved:
                self._recent.append(rec)
            firing = self._firing_locked(tick, now)
        return {"fired": fired, "resolved": resolved, "firing": firing}

    def _alert_dict(self, rule: AlertRule, series_key: tuple,
                    st: _SeriesState, tick: int, now: float,
                    state: str, samples: list | None = None) -> dict:
        return {
            "rule": rule.name,
            "severity": rule.severity,
            "state": state,
            "family": rule.family,
            "labels": dict(series_key),
            "value": st.last_value,
            "predicate": dict(rule.predicate),
            "for_ticks": rule.for_ticks,
            "description": rule.description,
            "since_tick": st.since_tick,
            "since_ts": st.since_ts,
            "tick": tick,
            "ts": now,
            "samples": list(samples if samples is not None else st.samples),
        }

    def _firing_locked(self, tick: int, now: float) -> list[dict]:
        by_name = {r.name: r for r in self.rules}
        out = []
        for (rule_name, series_key), st in sorted(
                self._states.items(), key=lambda kv: kv[0]):
            if st.firing:
                out.append(self._alert_dict(
                    by_name[rule_name], series_key, st, tick, now,
                    state="firing"))
        return out

    # --- reads (HTTP handler threads) ---

    def firing(self) -> list[dict]:
        with self._lock:
            tick = max((st.since_tick for st in self._states.values()
                        if st.firing), default=-1)
            return self._firing_locked(tick, round(time.time(), 6))

    def firing_counts(self) -> dict[str, int]:
        """``{rule name -> firing series count}`` for the
        ``fleet_alerts_firing`` gauge family (rules with zero firing
        series included, so resolution is visible as 0, not absence)."""
        with self._lock:
            counts = {rule.name: 0 for rule in self.rules}
            for (rule_name, _series_key), st in self._states.items():
                if st.firing:
                    counts[rule_name] = counts.get(rule_name, 0) + 1
            return counts

    def forget(self, replica_id: str) -> None:
        """Drop every (rule, series) state whose series labels carry
        ``replica=<id>`` — the scale-down/removal path (the
        ScrapeCache.forget / StragglerDetector.forget discipline).  A
        departed replica's series vanish from the exposition, and the
        freeze-on-missing rule would otherwise pin its firing alerts
        (and grow ``_states``) forever.  Firing states leave a synthetic
        resolved record in the recent ring so the lifecycle stays
        traceable."""
        now = round(time.time(), 6)
        with self._lock:
            for key in [k for k in self._states
                        if ("replica", replica_id) in k[1]]:
                st = self._states.pop(key)
                if st.firing:
                    self._recent.append({
                        "rule": key[0], "state": "resolved",
                        "labels": dict(key[1]), "value": st.last_value,
                        "ts": now, "since_ts": st.since_ts,
                        "note": "replica removed from the fleet"})

    def recent(self) -> list[dict]:
        with self._lock:
            return [dict(rec) for rec in self._recent]

    def rules_table(self) -> list[dict]:
        counts = self.firing_counts()
        return [{**rule.to_json(), "firing_series": counts.get(rule.name, 0)}
                for rule in self.rules]


# --- the on-disk firing bundle ---


def write_alert_bundle(directory: str, *, alert: dict, rule: dict,
                       window: list[dict]) -> str | None:
    """One self-contained alert bundle under ``directory``.

    Layout: ``alert-<unixms>-<hex6>/`` holding ``manifest.json`` (the
    rule, the firing alert with its evaluated samples) and
    ``history.json`` (the history window that fired it, in the lossless
    strict-JSON family shape) — every alert reconstructible from disk.
    Built under a ``.part`` name and renamed; oldest bundles beyond
    :data:`MAX_ALERT_BUNDLES_KEPT` swept; returns the path or None —
    alerting must never become a second failure (the
    ``write_incident_bundle`` contract)."""
    try:
        os.makedirs(directory, exist_ok=True)
        name = (f"alert-{int(time.time() * 1000):013d}-"
                f"{uuid.uuid4().hex[:6]}")
        final = os.path.join(directory, name)
        tmp = f"{final}.part"
        os.makedirs(tmp)
        manifest = {
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "alert": alert,
            "rule": rule,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=1, default=str)
            fh.write("\n")
        with open(os.path.join(tmp, "history.json"), "w") as fh:
            json.dump({"ticks": window}, fh, indent=1, default=str)
            fh.write("\n")
        os.replace(tmp, final)
        bundles = sorted(n for n in os.listdir(directory)
                         if n.startswith("alert-")
                         and not n.endswith(".part"))
        for old in bundles[:-MAX_ALERT_BUNDLES_KEPT]:
            try:
                shutil.rmtree(os.path.join(directory, old))
            except OSError:
                pass
        return final
    except Exception:  # noqa: BLE001 — best-effort by contract
        return None


def list_alert_bundles(directory: str) -> list[dict]:
    """Bundle inventory for ``GET /fleet/alerts`` (name / rule /
    severity / ts)."""
    out: list[dict] = []
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("alert-")
                       and not n.endswith(".part"))
    except OSError:
        return out
    for name in names:
        entry = {"name": name, "path": os.path.join(directory, name)}
        try:
            with open(os.path.join(directory, name, "manifest.json")) as fh:
                m = json.load(fh)
            alert = m.get("alert", {})
            entry.update(rule=alert.get("rule"),
                         severity=alert.get("severity"),
                         labels=alert.get("labels"), ts=m.get("ts"))
        except (OSError, ValueError):
            entry["rule"] = "unreadable manifest"
        out.append(entry)
    return out


# --- delivery sinks (webhook / command), off the poll thread ---


class AlertSinks:
    """Bounded-queue transition delivery to ``--alert_webhook`` /
    ``--alert_cmd``, on ONE daemon worker thread — a slow receiver must
    not stall health polling or failover sweeps (the one-wedged-replica
    discipline applied to alerting).  Each delivery retries on the
    full-jitter ladder; outcomes land on the router's
    ``fleet_alert_notifications_total{sink,status}`` counter via the
    injected hook.  The queue is bounded: under a transition storm the
    newest notification is dropped (and counted) rather than growing
    without bound."""

    QUEUE_MAX = 256

    def __init__(self, webhook: str = "", command: str = "",
                 retries: int = 3, retry_backoff_s: float = 0.25,
                 timeout_s: float = 10.0, note=None,
                 quiet: bool = True) -> None:
        self.webhook = webhook
        self.command = command
        self.retries = max(int(retries), 0)
        self.retry_backoff_s = float(retry_backoff_s)
        self.timeout_s = float(timeout_s)
        self.quiet = quiet
        self._note = note or (lambda sink, status: None)
        self._rng = backoff.make_rng()
        self._q: queue.Queue = queue.Queue(maxsize=self.QUEUE_MAX)
        self._stop_evt = threading.Event()
        self._thread = None
        if self.webhook or self.command:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="ict-fleet-alert-sink")
            self._thread.start()

    def active(self) -> bool:
        return self._thread is not None

    def notify(self, transition: dict) -> None:
        if self._thread is None:
            return
        try:
            self._q.put_nowait(transition)
        except queue.Full:
            self._note("queue", "dropped")

    def stop(self, timeout_s: float = 5.0) -> None:
        """Never blocks on the queue: a full queue behind a wedged sink
        must not turn router shutdown into a minutes-long retry drain.
        The stop event aborts the worker between deliveries and between
        retry sleeps; the worker is daemonic, so a join timeout only
        delays, never prevents, process exit."""
        if self._thread is None:
            return
        self._stop_evt.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass   # the event alone stops the worker after this item
        self._thread.join(timeout=timeout_s)

    # --- the worker ---

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None or self._stop_evt.is_set():
                return
            payload = json.dumps(item, default=str)
            if self.webhook:
                self._deliver("webhook", payload, self._post_webhook)
            if self.command:
                self._deliver("cmd", payload, self._run_command)

    def _deliver(self, sink: str, payload: str, attempt_fn) -> None:
        for attempt in range(1 + self.retries):
            if self._stop_evt.is_set():
                self._note(sink, "dropped")
                return
            if attempt and self._stop_evt.wait(backoff.full_jitter(
                    self.retry_backoff_s, attempt - 1, rng=self._rng)):
                self._note(sink, "dropped")
                return
            try:
                attempt_fn(payload)
            except Exception as exc:  # noqa: BLE001 — retried, then counted
                if attempt == self.retries and not self.quiet:
                    print(f"ict-fleet: alert {sink} delivery failed after "
                          f"{1 + self.retries} attempts ({exc!r})",
                          file=sys.stderr)
                continue
            self._note(sink, "ok")
            return
        self._note(sink, "error")

    def _post_webhook(self, payload: str) -> None:
        req = urllib.request.Request(
            self.webhook, data=payload.encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()

    def _run_command(self, payload: str) -> None:
        proc = subprocess.run(
            self.command, shell=True, input=payload.encode(),
            timeout=self.timeout_s, capture_output=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"alert command exited {proc.returncode}")
