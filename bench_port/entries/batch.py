"""Entry ``batch``: ``parallel/batch.clean_archives(archives, cfg, mesh)`` on
one directory batch of in-memory raw archives, the configuration's
``batch`` of them, over this process's mesh of the device
(``parallel/multihost.local_mesh``): the host preprocess of each archive on
the batch's small pool, one bucket of one shape, its upload, the batched
loop with both hand kernels over the archive axis, and each archive's
finalize, as ``driver.run_sharded_batch`` cleans a directory without its
file reads and writes.

One input is one batch, so the harness's ``archives_per_s`` counts batches
a second and ``archive_s_p90`` is a batch's wall-clock.  The traffic's
``archive_pool`` holds the base seeds of every archive of a run, as many as
``inputs`` times ``batch``: a seed draws their order and a subint shuffle
for each, and the inputs take them ``batch`` at a time, so every run cleans
the same archives (a batch stops only when its last archive stops).  The
answer holds a part per archive, in the batch's order; the reference
cleans each archive alone, whose answer the batch's equals.
"""

import numpy as np

from bench_port.entry_base import Base, sync
from bench_port.reference import clean as ref


class Entry(Base):
    def __init__(self, config, traffic, device) -> None:
        super().__init__(config, traffic, device)
        self.batch = int(config["batch"])
        self.pool = [int(s) for s in traffic["archive_pool"]]
        if len(self.pool) != self.batch * int(traffic["inputs"]):
            raise ValueError(f"the archive pool holds {len(self.pool)} seeds for "
                             f"{traffic['inputs']} inputs of {self.batch} archives")

    def sources(self, seed: int) -> list[list[tuple[int, int]]]:
        rng = np.random.default_rng(seed % (1 << 64))
        each = [(self.pool[i], int(rng.integers(1 << 62))) for i in rng.permutation(len(self.pool))]
        return [each[k:k + self.batch] for k in range(0, len(each), self.batch)]

    def make(self, source: list[tuple[int, int]]) -> dict:
        return {"parts": [Base.make(self, s) for s in source]}

    def kernels(self) -> dict:
        launch = {"narch": self.batch, "shape": self.shape}
        return {"fused_fit_moments": launch, "ordered_template": dict(launch)}

    def serve(self, inp: dict) -> list[dict]:
        from iterative_cleaner_tpu_torch.parallel.batch import clean_archives
        from iterative_cleaner_tpu_torch.parallel.multihost import local_mesh

        items = clean_archives([p["archive"] for p in inp["parts"]], self.cfg,
                               mesh=local_mesh(self.device))
        sync(self.device)
        failed = [it.error for it in items if it.error is not None]
        if failed:
            raise RuntimeError(f"{len(failed)} archive(s) of the batch failed: {failed[0]}")
        return [{"weights": it.weights, "scores": it.test_results, "loops": it.loops}
                for it in items]

    def reference(self, inp: dict, precision: str) -> list[dict]:
        out = []
        for part in inp["parts"]:
            D, w0 = ref.preprocess(part, self.device, precision)
            out.append(self.reference_clean(D, w0, self.cfg, precision))
            del D
        return out
