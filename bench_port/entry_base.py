"""What every entry point of the benchmark shares.

An entry lives in ``bench_port/entries/<name>.py`` and defines a class
``Entry``; a traffic file names it under ``"entry"``, and the harness loads
the file by that name (``harness.entry_class``), so a later cell that needs
a new entry adds a file and edits none.  An entry makes the cell's distinct
inputs from the seed (before the window), serves one input through the
program (the timed call), and works the same input out again with the plain
reference (after the window).  Both sides return an answer: a list of
parts, each ``{"weights", "scores", "loops"}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_port import gen
from bench_port.reference import clean as ref


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def archive(inp: dict):
    """The program's in-memory ``Archive`` of a raw input from ``gen``."""
    from iterative_cleaner_tpu_torch.io.base import Archive

    return Archive(data=inp["data"], weights=inp["weights"], freqs=inp["freqs"],
                   centre_frequency=inp["centre_frequency"], dm=inp["dm"],
                   period=inp["period"], state=inp["state"])


class Base:
    """One entry over one configuration and one traffic mix on ``device``."""

    #: Which input the generator makes: ``raw_archive`` (with the program's
    #: ``Archive`` of it under ``"archive"``) or ``preprocessed_cube``.
    makes = "raw_archive"

    def __init__(self, config: dict, traffic: dict, device) -> None:
        from iterative_cleaner_tpu_torch.config import CleanConfig

        self.config, self.traffic, self.device = config, traffic, device
        opts = {**config["clean"], **traffic.get("clean", {})}
        fields = {f.name for f in dataclasses.fields(CleanConfig)}
        unknown = sorted(set(opts) - fields)
        if unknown:
            raise ValueError(f"unknown cleaning options {unknown}")
        self.cfg = CleanConfig(**opts)
        self.shape = tuple(int(config[k]) for k in ("nsub", "nchan", "nbin"))
        pool = traffic.get("pool")
        if pool is not None and len(pool) != int(traffic["inputs"]):
            raise ValueError(f"the pool holds {len(pool)} seeds for {traffic['inputs']} inputs")

    def sources(self, seed: int) -> list[tuple[int, int | None]]:
        """What each distinct input of a run with ``seed`` is made from, in
        the order the run serves them: ``(seed + k, None)`` for the
        traffic's ``inputs``; or, where the traffic names a ``pool`` of base
        seeds, every one of them in an order drawn from ``seed``, each with
        a seed of its own that shuffles its subints.  A pool gives every
        run the same work, however the cleaner's loop counts fall on the
        bases, and still different bytes for every seed."""
        pool = self.traffic.get("pool")
        if pool is None:
            return [(seed + k, None) for k in range(int(self.traffic["inputs"]))]
        rng = np.random.default_rng(seed % (1 << 64))
        return [(int(pool[i]), int(rng.integers(1 << 62))) for i in rng.permutation(len(pool))]

    def make(self, source: tuple[int, int | None]) -> dict:
        cfg = {**self.config, "rfi": {**self.config["rfi"], **self.traffic.get("rfi", {})}}
        seed, shuffle = source
        extra = {} if shuffle is None else {"shuffle": shuffle}
        inp = getattr(gen, self.makes)(cfg, seed, self.device, **extra)
        sync(self.device)
        if self.makes == "raw_archive":
            inp["archive"] = archive(inp)
        return inp

    def kernels(self) -> dict:
        """The launches of each hand kernel that one call makes, as
        ``bounds.COSTS`` takes them, for the roofline readers."""
        one = {"narch": 1, "shape": self.shape}
        return {"fused_fit_moments": one, "ordered_template": {**one, "reads": 1}}

    def reference_clean(self, D, w0, cfg, precision, D_host=None) -> dict:
        return ref.clean(D, w0, cfg.chanthresh, cfg.subintthresh, cfg.max_iter,
                         cfg.pulse_region, precision=precision,
                         block=int(self.traffic.get("reference_block", 64)), D_host=D_host)
