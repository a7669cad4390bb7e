"""ict-serve-torch: the long-running cleaning service of the port.

A port of ``iterative_cleaner_tpu/service/``, with the same endpoints, job
manifests and spool layout, so the JAX daemon and this one read each
other's spools.  Every other entry point (CLI, driver.run, the directory
batchers) is one-shot — load, clean, exit — paying kernel loads and device
setup per invocation; this subsystem keeps one process alive on one card:

- :mod:`.context`   — ReplicaContext: one replica's identity + shared
                      mutable state (job index, idempotency map, demotion
                      machine, drain flag) — scheduler/worker/pool are
                      constructed from it alone, so several replicas can
                      live in one process
- :mod:`.jobs`      — job records + on-disk spool (restart-safe manifest)
- :mod:`.scheduler` — shape-bucketed admission queue (bucket cap / deadline)
- :mod:`.worker`    — fault-isolated dispatch (retry, oracle fallback)
- :mod:`.pool`      — warm pool (a zero dispatch per declared batch size)
- :mod:`.sessions`  — streaming sessions over ``online.OnlineSession``
- :mod:`.api`       — stdlib-HTTP endpoints (/jobs, /jobs/<id>/trace,
                      /sessions, /healthz, Prometheus /metrics, /costs)
- :mod:`.daemon`    — lifecycle + the ``serve`` sub-command

Loader threads read archives (``.ictb`` through the native runtime, or
``.npz``) and preprocess them on the host (``ops/preprocess``, native when
it builds); every job carries a telemetry trace_id from submission through
dispatch; ``--telemetry`` appends the JSON-lines event log.

The service is routing, not math: masks stay bit-identical to the numpy
oracle on every served route (the batched dispatch is pinned by
tests/test_torch_batch.py; the degraded route IS the oracle).
"""

from iterative_cleaner_tpu_torch.service.jobs import Job, JobSpool
from iterative_cleaner_tpu_torch.service.context import ReplicaContext, ServiceBusy
from iterative_cleaner_tpu_torch.service.daemon import CleaningService, ServeConfig

__all__ = ["Job", "JobSpool", "CleaningService", "ServeConfig",
           "ReplicaContext", "ServiceBusy"]
