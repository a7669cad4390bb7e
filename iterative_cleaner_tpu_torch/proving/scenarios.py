"""Named, seeded, deterministic synthetic workload generators.

Port of ``iterative_cleaner_tpu/proving/scenarios.py``.

Each scenario is a generator over :mod:`io/synthetic`'s fully-seeded
archive builder: the same ``(workdir-relative name, seed)`` always yields
byte-identical ``.npz`` cubes and identical submission metadata, so a
proving run is reproducible end to end (the determinism test pins
``same seed → byte-identical cube stream``).  Scenarios compose into one
mixed stream via :func:`build_mix`, which interleaves them with a seeded
shuffle — the arrival ORDER is part of the workload and must reproduce
too.

The catalog (docs/PROVING.md carries the full table):

- ``small_flood`` — many distinct small cubes (the campaign-of-small-jobs
  class the coalescing tier exists for);
- ``big_wall`` — fewer, larger cubes (a different shape bucket, so the
  scheduler's bucketing and the capacity model's per-bucket rows are both
  exercised);
- ``duplicate_storm`` — ONE cube submitted N times under N distinct
  idempotency keys: copies after the first must be served born-terminal
  by the fleet's content-addressed result cache, with the exactly-once
  completion ledger unmoved;
- ``tenant_mix`` — distinct cubes alternating across two tenants (quota /
  weighted-fair-queueing contention under the router's admission plane);
- ``all_rfi`` — pathologically contaminated archives (every injection
  morphology cranked up): the cleaner must converge and the masks must
  still match the numpy oracle bit-for-bit.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass

from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import RFISpec, make_archive

#: The smoke/test small-cube class (the bench/coalesce shape).
SMALL_SHAPE = (4, 16, 64)
#: The big-wall class: a different scheduler bucket, still CI-sized.
BIG_SHAPE = (8, 32, 128)

#: Every injection morphology cranked well past the default mix —
#: the pathological all-RFI class.  Amplitude stays finite so the
#: synthetic pulse is still in there to find.
ALL_RFI_SPEC = RFISpec(n_profile_spikes=24, n_dc_profiles=12,
                       n_bad_channels=5, n_bad_subints=2,
                       n_prezapped=8, amplitude=120.0)


@dataclass(frozen=True)
class Submission:
    """One scenario arrival: everything a fleet submission needs."""

    path: str
    tenant: str
    idem_key: str
    shape: tuple
    scenario: str

    def job_body(self) -> dict:
        return {"path": self.path, "idempotency_key": self.idem_key,
                "shape": list(self.shape)}


def _cube(workdir: str, name: str, shape: tuple, seed: int,
          rfi: RFISpec | None = None) -> str:
    import os

    nsub, nchan, nbin = shape
    path = os.path.join(workdir, name)
    if not os.path.exists(path):   # generators are re-runnable in place
        kw = {"rfi": rfi} if rfi is not None else {}
        NpzIO().save(make_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                  seed=seed, **kw), path)
    return path


def gen_small_flood(workdir: str, seed: int, count: int) -> list[Submission]:
    return [Submission(
        path=_cube(workdir, f"flood_{seed}_{i}.npz", SMALL_SHAPE, seed + i),
        tenant="flood", idem_key=f"flood:{seed}:{i}",
        shape=SMALL_SHAPE, scenario="small_flood") for i in range(count)]


def gen_big_wall(workdir: str, seed: int, count: int) -> list[Submission]:
    return [Submission(
        path=_cube(workdir, f"wall_{seed}_{i}.npz", BIG_SHAPE,
                   10_000 + seed + i),
        tenant="wall", idem_key=f"wall:{seed}:{i}",
        shape=BIG_SHAPE, scenario="big_wall") for i in range(count)]


def gen_duplicate_storm(workdir: str, seed: int,
                        count: int) -> list[Submission]:
    """ONE cube, ``count`` submissions under DISTINCT idempotency keys:
    the replica-side idempotency map cannot dedupe these — only the
    fleet's content-addressed result cache can, which is the point."""
    path = _cube(workdir, f"storm_{seed}.npz", SMALL_SHAPE, 20_000 + seed)
    return [Submission(
        path=path, tenant="storm", idem_key=f"storm:{seed}:{i}",
        shape=SMALL_SHAPE, scenario="duplicate_storm")
        for i in range(count)]


def gen_tenant_mix(workdir: str, seed: int, count: int) -> list[Submission]:
    return [Submission(
        path=_cube(workdir, f"mix_{seed}_{i}.npz", SMALL_SHAPE,
                   30_000 + seed + i),
        tenant=("mix-a" if i % 2 == 0 else "mix-b"),
        idem_key=f"mix:{seed}:{i}",
        shape=SMALL_SHAPE, scenario="tenant_mix") for i in range(count)]


def gen_all_rfi(workdir: str, seed: int, count: int) -> list[Submission]:
    return [Submission(
        path=_cube(workdir, f"rfi_{seed}_{i}.npz", SMALL_SHAPE,
                   40_000 + seed + i, rfi=ALL_RFI_SPEC),
        tenant="rfi", idem_key=f"rfi:{seed}:{i}",
        shape=SMALL_SHAPE, scenario="all_rfi") for i in range(count)]


#: The scenario catalog: name -> generator(workdir, seed, count).
SCENARIOS = {
    "small_flood": gen_small_flood,
    "big_wall": gen_big_wall,
    "duplicate_storm": gen_duplicate_storm,
    "tenant_mix": gen_tenant_mix,
    "all_rfi": gen_all_rfi,
}

#: One tick of the CI smoke lane: every scenario class represented, the
#: whole mix small enough for the ~90 s budget alongside one chaos drill.
SMOKE_MIX = {"small_flood": 2, "big_wall": 1, "duplicate_storm": 3,
             "tenant_mix": 2, "all_rfi": 1}

#: The full-soak default mix per tick.
FULL_MIX = {"small_flood": 4, "big_wall": 2, "duplicate_storm": 4,
            "tenant_mix": 4, "all_rfi": 2}


def build_mix(workdir: str, seed: int,
              counts: dict[str, int]) -> list[Submission]:
    """Generate each named scenario and interleave them with a seeded
    shuffle — deterministic for a (seed, counts) pair, including arrival
    order.  Unknown scenario names raise (a typo'd mix must not silently
    prove less than it claims)."""
    unknown = sorted(set(counts) - set(SCENARIOS))
    if unknown:
        raise ValueError(f"unknown scenario(s) {unknown}; catalog: "
                         f"{sorted(SCENARIOS)}")
    subs: list[Submission] = []
    for name in sorted(counts):
        n = int(counts[name])
        if n > 0:
            subs.extend(SCENARIOS[name](workdir, seed, n))
    # Seeded interleave; duplicate-storm copies keep their relative order
    # (stable sort on a seeded draw) so "first copy, then the echoes"
    # remains a meaningful phase for the CAS assertion.
    rng = random.Random(seed)
    draws = {id(s): rng.random() for s in subs}
    subs.sort(key=lambda s: (draws[id(s)], s.idem_key))
    storm = [s for s in subs if s.scenario == "duplicate_storm"]
    if storm:
        rest = [s for s in subs if s.scenario != "duplicate_storm"]
        first = min(storm, key=lambda s: s.idem_key)
        subs = [first, *rest, *[s for s in storm if s is not first]]
    return subs


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def mix_digest(subs: list[Submission]) -> str:
    """One hex digest over the whole stream — cube bytes AND submission
    metadata in arrival order — the determinism test's single figure."""
    h = hashlib.sha256()
    for s in subs:
        h.update(f"{s.scenario}|{s.tenant}|{s.idem_key}|{s.shape}|"
                 f"{file_digest(s.path)}\n".encode())
    return h.hexdigest()


def campaign_manifest(subs: list[Submission], name: str,
                      tenant: str = "prove-survey") -> dict:
    """A ``POST /campaigns`` body over a scenario stream: campaigns as a
    workload source (the orchestrator pins its own per-archive
    idempotency keys, so the stream's keys are not carried over)."""
    return {"name": name, "tenant": tenant,
            "archives": [s.path for s in subs],
            "config": {"lane": "ict-clean prove"}}
