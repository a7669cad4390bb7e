"""Invariant-aware static analysis for the port's tree.

The port of ``iterative_cleaner_tpu/analysis/``: three layers, one finding
vocabulary, aimed at ``iterative_cleaner_tpu_torch/``, ``tools_torch/`` and
``chip_smoke.py``:

- :mod:`.rules` — AST source lint over the project's load-bearing
  conventions (guarded CUDA initialisation, mask-path determinism and
  dtype discipline in torch's spellings, the Prometheus metric grammar);
- :mod:`.races` — the static race detector for the threaded modules
  (``service/``, ``obs/``, ``fleet/``, ``campaign/``, ``proving/`` and the
  modules whose locks their threads share): shared state must carry
  ``# ict: guarded-by(<lock>)`` annotations, annotated writes must happen
  under their lock, and the lock-acquisition graph must be cycle-free;
- :mod:`.contracts` — torch route contracts: each clean route (stepwise,
  fused, chunked, batch) runs on a tiny cube under torch's function and
  dispatch modes, its host reads are held against a ledger and no 64-bit
  float appears on the float32 routes; on the card each route's CUDA
  synchronisations are held against the same ledger.

``tools_torch/ict_lint.py`` is the CLI; findings are suppressible only
through the checked-in ``tools_torch/ict_lint_baseline.json``.  Nothing
here imports jax or the JAX package (``analysis/bench_cfg.py`` — the ICT004
``bench.py`` rule — waits for the port's benchmark tool).
"""

from iterative_cleaner_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    collect_project_files,
    load_baseline,
    parse_annotations,
)
