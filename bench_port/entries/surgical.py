"""Entry ``surgical``: ``models/surgical.SurgicalCleaner(cfg).clean(archive)``
on an in-memory raw archive: preprocessing, the warm-up thread, the upload,
the loop, the bad-parts sweep and the output policy."""

from bench_port.entry_base import Base, sync
from bench_port.reference import clean as ref


class Entry(Base):
    def serve(self, inp: dict) -> list[dict]:
        from iterative_cleaner_tpu_torch.models.surgical import SurgicalCleaner

        out = SurgicalCleaner(self.cfg, device=self.device).clean(inp["archive"])
        sync(self.device)
        return [{"weights": out.cleaned.weights, "scores": out.result.test_results,
                 "loops": out.result.loops}]

    def reference(self, inp: dict, precision: str) -> list[dict]:
        D, w0 = ref.preprocess(inp, self.device, precision)
        return [self.reference_clean(D, w0, self.cfg, precision)]
