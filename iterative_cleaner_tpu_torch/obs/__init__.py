"""obs — the structured-telemetry layer of the port.

The port of ``iterative_cleaner_tpu/obs/`` (docs/OBSERVABILITY.md), with
the JAX package's module names and public names:

- :mod:`.events`    — trace context (``trace_id``/``span_id``) minted at
                      the CLI run and the online session, and the
                      JSON-lines event log (``--telemetry out.jsonl`` /
                      ``ICT_TELEMETRY``);
- :mod:`.tracing`   — the process-global counter registry: log2-bucket
                      latency histograms, error counters, labeled counters
                      and gauges, and the kernel-build accounting that
                      stands for the JAX package's compile listener;
- :mod:`.metrics`   — Prometheus text exposition over the registry and its
                      strict parser;
- :mod:`.forensics` — convergence forensics: per-diagnostic zap
                      attribution and termination reasons;
- :mod:`.flight`    — the always-on bounded flight-recorder ring;
- :mod:`.profiling` — ``torch.profiler`` captures: the ``--trace`` one-shot
                      and bounded on-demand captures;
- :mod:`.memory`    — device-memory / host-RSS accounting on
                      ``torch.cuda.memory_stats``;
- :mod:`.audit`     — oracle parity auditing, score-drift accounting,
                      divergence repro bundles and the serving daemon's
                      shadow auditor;
- :mod:`.quality`   — RFI data-quality telemetry;
- :mod:`.costs`     — the serving daemon's per-job cost records and its
                      showback ledger.

Everything here is read-only on the math: no hook touches a mask, and
every hook is a no-op when its sink is disabled.
"""

from iterative_cleaner_tpu_torch.obs import (
    audit,
    costs,
    events,
    flight,
    forensics,
    memory,
    metrics,
    profiling,
    quality,
    tracing,
)

__all__ = ["audit", "costs", "events", "flight", "forensics", "memory", "metrics",
           "profiling", "quality", "tracing"]
