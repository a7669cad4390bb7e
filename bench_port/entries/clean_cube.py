"""Entry ``clean_cube``: ``core/cleaner.clean_cube(D, w0, cfg)`` on a
preprocessed host cube, its upload included."""

import torch

from bench_port.entry_base import Base, sync


class Entry(Base):
    makes = "preprocessed_cube"

    def serve(self, inp: dict) -> list[dict]:
        from iterative_cleaner_tpu_torch.core.cleaner import clean_cube

        res = clean_cube(inp["D"], inp["w0"], self.cfg, device=self.device)
        sync(self.device)
        return [{"weights": res.weights, "scores": res.test_results, "loops": res.loops}]

    def reference(self, inp: dict, precision: str) -> list[dict]:
        D = torch.from_numpy(inp["D"]).to(self.device)
        return [self.reference_clean(D, inp["w0"], self.cfg, precision, D_host=inp["D"])]
