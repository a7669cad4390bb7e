"""ict-prove: the million-job proving ground.

Port of ``iterative_cleaner_tpu/proving/__init__.py``.

The fleet stack measures, alerts, autoscales, dedupes, accounts, and runs
campaigns — this package is what *demonstrates* those control loops
closing under realistic load and injected faults, instead of leaving each
one to its own hand-built smoke:

- :mod:`.traces` — record a replayable submission trace from the
  JSON-lines event log, and re-issue it against a live router at N× time
  compression under the original idempotency keys;
- :mod:`.scenarios` — named, seeded, deterministic synthetic workload
  generators (small-cube floods, big-cube walls, byte-identical duplicate
  storms, mixed-tenant contention, pathological all-RFI archives)
  composable into one mixed stream;
- :mod:`.chaos` — scheduled fault injection with explicit heal
  assertions: every injected fault must surface as a firing alert, heal
  autonomously (failover / traffic re-route / restart-recover), and
  reconcile in the cost ledger;
- :mod:`.soak` — the ``ict-clean-torch prove`` driver: scenario mix + chaos
  schedule against an in-process fleet for a bounded budget, one JSON
  verdict enforcing the invariant triad (zero lost jobs, bit-identical
  masks, cost conservation).

Full docs: ``docs/PROVING.md``.
"""
