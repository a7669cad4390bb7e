"""Multi-tenant admission for the fleet router: quotas + weighted fair
queueing.

Port of ``iterative_cleaner_tpu/fleet/tenants.py``.

Two independent mechanisms, both keyed on the ``X-ICT-Tenant`` header
(absent -> the ``"default"`` tenant):

- **Quotas** are hard per-tenant caps on *open placements* (placed but
  not yet observed terminal).  A breach raises :class:`QuotaExceeded`,
  which the router maps to ``429`` with ``Retry-After`` — the tenant is
  told to back off, the fleet is not.
- **Weighted fair queueing** orders *placement grants* when submissions
  contend for the router's in-flight budget (``--max_inflight``).  The
  classic virtual-finish-time discipline: each tenant's next grant is
  stamped ``start = max(now_virtual, tenant_last_finish)``,
  ``finish = start + 1/weight``, and grants pop in finish order — a
  weight-3 tenant gets three grants for every one a weight-1 tenant
  gets under sustained contention, while an idle tenant's first
  submission is never starved (its start snaps to the current virtual
  time, not its ancient last finish).

The arbiter is deterministic given the enqueue order (ties break on
sequence number), which is what makes the fairness tests exact rather
than statistical.
"""

from __future__ import annotations

import heapq
import threading

DEFAULT_TENANT = "default"

#: Reserved identity for the router's own synthetic canary traffic
#: (fleet/canary.py).  Jobs under this tenant are stamped
#: ``synthetic=true`` end-to-end and are excluded from capacity demand,
#: tenant quotas, and cost showback — a probe that moved the planes it
#: measures would be measuring itself.
SYNTHETIC_TENANT = "_canary"


class QuotaExceeded(RuntimeError):
    """Per-tenant open-placement cap reached (HTTP 429 + Retry-After)."""

    def __init__(self, tenant: str, open_n: int, quota: int) -> None:
        super().__init__(
            f"tenant {tenant!r} has {open_n} open placements at its quota "
            f"({quota}); retry later")
        self.tenant = tenant


class WeightedFairQueue:
    """Virtual-time WFQ over opaque items.  NOT thread-safe by itself —
    the router serializes access under its placement lock (one lock for
    queue + inflight budget keeps the grant decision atomic)."""

    def __init__(self, weights: dict[str, float] | None = None,
                 default_weight: float = 1.0) -> None:
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self._heap: list = []        # (finish, seq, tenant, item)
        self._seq = 0                # FIFO tie-break within equal finishes
        self._vtime = 0.0            # current virtual time
        self._last_finish: dict[str, float] = {}

    def weight(self, tenant: str) -> float:
        w = float(self.weights.get(tenant, self.default_weight))
        return w if w > 0 else self.default_weight

    def push(self, tenant: str, item) -> None:
        start = max(self._vtime, self._last_finish.get(tenant, 0.0))
        finish = start + 1.0 / self.weight(tenant)
        self._last_finish[tenant] = finish
        heapq.heappush(self._heap, (finish, self._seq, tenant, item))
        self._seq += 1

    def pop(self):
        """Next (tenant, item) in weighted-fair order; None when empty.
        Advances the virtual clock to the granted finish time, so a
        tenant that was idle through the contention rejoins at the
        current service level instead of burning its backlog credit."""
        if not self._heap:
            return None
        finish, _seq, tenant, item = heapq.heappop(self._heap)
        self._vtime = max(self._vtime, finish)
        # Prune finish stamps the clock has passed: an entry <= vtime is
        # behaviorally identical to an absent one (push snaps start up to
        # vtime), and keeping them would grow one dict entry per distinct
        # tenant name EVER seen — an unauthenticated X-ICT-Tenant header
        # must not be an unbounded-memory hole in a weeks-lived router.
        self._last_finish = {t: f for t, f in self._last_finish.items()
                             if f > self._vtime}
        return tenant, item

    def __len__(self) -> int:
        return len(self._heap)


class TenantAdmission:
    """Quota bookkeeping: open placements per tenant, checked and counted
    atomically at admission, released when the router observes the
    placement terminal (or fails to place it at all)."""

    def __init__(self, quotas: dict[str, int] | None = None,
                 default_quota: int = 0) -> None:
        # quota 0 = unbounded (the ServeConfig.max_open_jobs convention).
        self.quotas = dict(quotas or {})
        self.default_quota = int(default_quota)
        self._lock = threading.Lock()
        self._open: dict[str, int] = {}  # ict: guarded-by(self._lock)

    def quota(self, tenant: str) -> int:
        return int(self.quotas.get(tenant, self.default_quota))

    def admit(self, tenant: str) -> None:
        """Check-and-count under ONE lock hold (two racing submissions
        must not both pass the check at quota-1)."""
        with self._lock:
            open_n = self._open.get(tenant, 0)
            quota = self.quota(tenant)
            if quota and open_n >= quota:
                raise QuotaExceeded(tenant, open_n, quota)
            self._open[tenant] = open_n + 1

    def release(self, tenant: str) -> None:
        with self._lock:
            n = self._open.get(tenant, 0) - 1
            if n > 0:
                self._open[tenant] = n
            else:
                self._open.pop(tenant, None)

    def open_count(self, tenant: str) -> int:
        with self._lock:
            return self._open.get(tenant, 0)
