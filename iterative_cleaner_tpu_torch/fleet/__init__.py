"""ict-fleet: the front-end router + replica-aware serving tier.

Port of ``iterative_cleaner_tpu/fleet/__init__.py``.

One :class:`~.daemon.CleaningService` replica serves one host; survey-scale
real-time RFI mitigation is a *fleet* problem (arXiv:1701.08197), so this
package puts a router process in front of N daemon replicas:

- :mod:`.client`   — stdlib-HTTP client for the replica API (/healthz,
                     /jobs, /drain) with transport-vs-HTTP error split
- :mod:`.registry` — replica records + health polling: liveness, drain
                     flags, per-shape-bucket queue depths, warm shapes
- :mod:`.tenants`  — multi-tenant admission: per-tenant quotas (429 +
                     Retry-After on breach) and weighted fair queueing
                     over placement order under contention
- :mod:`.router`   — the FleetRouter daemon: least-loaded-by-bucket
                     placement with a warm-cache affinity bonus, failover
                     re-routing with idempotency keys (a job never runs
                     twice on one replica), its own Prometheus /metrics,
                     and the ``serve-fleet`` CLI (+ ``--smoke``)
- :mod:`.obs`      — the fleet observability plane: /metrics federation
                     (per-replica re-labeling + exact merged families on
                     ``GET /fleet/metrics``), cross-hop trace assembly
                     (``GET /fleet/trace/<id>``), incident bundles under
                     ``<spool>/fleet-incidents/``, and SLO/straggler
                     detection feeding placement de-prioritization
- :mod:`.capacity` — the capacity model: per-bucket demand rates,
                     per-replica utilization/service rates, and the
                     cost-weighted backlog-drain ETA, rendered as
                     ``ict_fleet_capacity_*`` gauges and served at
                     ``GET /fleet/capacity``
- :mod:`.autoscale`— signal-driven elastic scaling: the
                     ReplicaSupervisor (spawn with full-jitter retries,
                     drain-then-stop scale-down) and the hysteresis +
                     cooldown Autoscaler behind ``--autoscale
                     advise|act``
- :mod:`.history`  — the bounded federated-metrics history ring: one
                     parsed exposition per poll tick (zero new scrape
                     traffic), lossless strict-JSON ticks at
                     ``GET /fleet/metrics/history``, the windowed
                     series the alert predicates evaluate over
- :mod:`.alerts`   — the declarative alerting plane: SLO rules
                     ``(name, severity, selector, predicate,
                     for_ticks)`` over the history, a firing->resolved
                     state machine with per-rule hysteresis, on-disk
                     firing bundles, webhook/command sinks, and the
                     default rule pack behind ``GET /fleet/alerts``

The router is routing, not math: every mask is produced by a replica,
and replicas stay bit-identical to the numpy oracle on every route
(docs/SERVING.md "Fleet").  Zero new dependencies — the router is the
same stdlib ``http.server`` + ``urllib`` stack the replicas use.
"""

from iterative_cleaner_tpu_torch.fleet.client import ReplicaClient
from iterative_cleaner_tpu_torch.fleet.registry import ReplicaRegistry
from iterative_cleaner_tpu_torch.fleet.router import FleetConfig, FleetRouter
from iterative_cleaner_tpu_torch.fleet.tenants import TenantAdmission

__all__ = ["ReplicaClient", "ReplicaRegistry", "FleetConfig", "FleetRouter",
           "TenantAdmission"]
