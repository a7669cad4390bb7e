"""Entry ``sweep``: on a raw archive, ``ops/preprocess.preprocess(archive)``
and then ``models/sweep.sweep_thresholds`` over the traffic's ``pairs`` on
the plain route (``kernel=False``), as ``driver.run_sweep`` does without its
file write.

``sweep_thresholds`` returns each pair's mask and loop count but not its
scores, so the timed call records the scores of the batched loop as the
sweep receives them: ``parallel/sharded.batched_fused_clean`` is wrapped
for the call, under that name in every module of the program that holds it.
Where the sweep stops calling it by that name, nothing is recorded, every
part's scores read as absent and the run is not correct: the check never
passes without the scores.
"""

import contextlib
import sys

import numpy as np

from bench_port.entry_base import Base, sync
from bench_port.reference import clean as ref

#: The program's batched loop, and the modules that may hold it by name.
LOOP = "batched_fused_clean"
HOLDERS = ("iterative_cleaner_tpu_torch.parallel.sharded",
           "iterative_cleaner_tpu_torch.models.sweep")


@contextlib.contextmanager
def recording_scores(scores: list):
    """Within the block, every call of the batched loop appends its scores
    (the first item of its return value) to ``scores``."""
    from iterative_cleaner_tpu_torch.parallel import sharded

    inner = getattr(sharded, LOOP)

    def recorded(*args, **kw):
        out = inner(*args, **kw)
        scores.append(out[0])
        return out

    mods = [sys.modules[m] for m in HOLDERS
            if m in sys.modules and getattr(sys.modules[m], LOOP, None) is inner]
    for mod in mods:
        setattr(mod, LOOP, recorded)
    try:
        yield
    finally:
        for mod in mods:
            setattr(mod, LOOP, inner)


class Entry(Base):
    def __init__(self, config, traffic, device) -> None:
        super().__init__(config, traffic, device)
        self.pairs = [tuple(float(v) for v in p) for p in traffic["pairs"]]
        self.cfg = self.cfg.replace(kernel=False)

    def kernels(self) -> dict:
        return {"ordered_template": {"narch": len(self.pairs), "shape": self.shape, "reads": 1}}

    def serve(self, inp: dict) -> list[dict]:
        from iterative_cleaner_tpu_torch.models.sweep import sweep_thresholds
        from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

        scores = []
        with recording_scores(scores):
            D, w0 = preprocess(inp["archive"])
            points = sweep_thresholds(D, w0, self.cfg, self.pairs, device=self.device)
        sync(self.device)
        test = np.concatenate([s.cpu().numpy() for s in scores]) if scores else []
        return [{"weights": p.weights, "scores": test[k] if k < len(test) else None,
                 "loops": p.loops} for k, p in enumerate(points)]

    def reference(self, inp: dict, precision: str) -> list[dict]:
        D, w0 = ref.preprocess(inp, self.device, precision)
        D_host = D.cpu().numpy()
        return [self.reference_clean(D, w0, self.cfg.replace(chanthresh=c, subintthresh=s),
                                     precision, D_host) for c, s in self.pairs]
