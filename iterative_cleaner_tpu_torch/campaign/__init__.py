"""Survey-campaign orchestration: thousands of archives as
one resumable, work-stealing, cost-accounted run.

Port of ``iterative_cleaner_tpu/campaign/__init__.py``.

A campaign is a JSON manifest (archive list/globs, tenant, optional
per-archive overrides) compiled into per-archive work items, each
submitted through the fleet router's ranked placement path under a
deterministic campaign-scoped idempotency key — so restart-resume and
failover stay exactly-once by construction, and duplicate archives
resolve born-terminal out of the fleet result cache.  The pieces:

- :mod:`.manifest` — the manifest grammar, validation/compilation, and
  the deterministic per-archive idempotency keys;
- :mod:`.store` — the spool-persisted campaign state machine
  (``<spool>/campaigns/<id>/``, .part-rename atomic, restart rehydrates);
- :mod:`.orchestrator` — the router-driven tick: submit pending
  archives, observe placements, fold terminal results, finish campaigns;
- :mod:`.rollup` — the cross-archive QA roll-up and cost showback folds
  served on ``GET /campaigns/<id>``;
- :mod:`.cli` — the ``ict-clean-torch campaign MANIFEST`` follow client.

Full grammar, API, and resume semantics: docs/SERVING.md "Campaigns".
"""

from iterative_cleaner_tpu_torch.campaign.manifest import (  # noqa: F401
    archive_idem_key,
    compile_manifest,
    new_campaign_id,
)
