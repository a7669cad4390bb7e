"""The staged host-to-card copy (``ingest/staging.py``) and ``to_device``'s
choice of it.

On the CPU: a pool writing into a CPU destination is the contiguous copy of
its source byte for byte, for every size around a piece, a contiguous source
and a strided one (the pol-0 plane ``data[:, 0]`` of a 4-pol cube), three
types and 1 to 5 copying threads; an exception in any thread reaches the
caller and leaves the pool whole; one fill is one upload to the route
contracts; ``to_device``'s CPU route and its small, cast and tensor cases
are as they were.

Marked ``card`` (skipped without a CUDA card, which is decided in a
fixture): the staged upload against ``torch.from_numpy(a).to(card)`` bit for
bit at 256 x 1024 x 1024 and on a strided Stokes plane, the allocator's peak
over an upload (the destination alone), no new pinned memory on a second
upload, ``SurgicalCleaner.clean`` with the staged and the pageable upload,
and the stepwise route contracts at that size.  On the card: ``python -m
pytest --noconftest -p no:cacheprovider -m card tests/test_torch_staging.py``
(the suite's conftest imports JAX; this file does not).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu_torch.analysis import contracts
from iterative_cleaner_tpu_torch.backends import torch_backend
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.ingest import staging
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.models.surgical import SurgicalCleaner
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

#: Elements of one piece in the CPU cases.
PIECE = 24
#: (nsub, nchan, nbin) of 0, 1, piece - 1, piece, piece + 1 and many pieces'
#: elements; rows of the last two are not multiples of a piece.
SHAPES = ((0, 3, 5), (1, 1, 1), (1, 1, PIECE - 1), (2, 3, 4), (1, 5, 5),
          (13, 1, 17), (7, 5, 9))
DTYPES = (np.float32, np.float64, np.int32)


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(threads, itemsize):
        key = (threads, itemsize)
        if key not in made:
            made[key] = staging.StagingPool("cpu", threads=threads,
                                            piece_bytes=PIECE * itemsize)
        return made[key]

    yield get
    for pool in made.values():
        pool.close()


def _source(shape, dtype, strided, seed=0):
    rng = np.random.default_rng(seed)
    nsub, nchan, nbin = shape
    cube = (rng.standard_normal((nsub, 4 if strided else 1, nchan, nbin)) * 1e3).astype(dtype)
    return cube[:, 0] if strided else np.ascontiguousarray(cube[:, 0])


@pytest.mark.parametrize("threads", [1, 2, 5])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "pol0"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fill_is_the_contiguous_copy(pools, shape, strided, dtype, threads):
    src = _source(shape, dtype, strided)
    plan = staging.piece_plan(src.size, PIECE)
    assert [lo for lo, _ in plan] == list(range(0, src.size, PIECE))
    assert all(hi - lo == PIECE for lo, hi in plan[:-1])
    assert (plan[-1][1] if plan else 0) == src.size
    dst = torch.full(src.shape, 7, dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
    assert pools(threads, src.itemsize).fill(dst, src) is dst
    assert dst.numpy().tobytes() == np.ascontiguousarray(src).tobytes()


@pytest.mark.parametrize("where", ["thread", "caller"])
def test_a_raising_copy_propagates_and_leaves_the_pool_whole(pools, monkeypatch, where):
    """The caller gathers the last piece; the others go to any thread."""
    pool = pools(3, 4)
    src = _source((13, 1, 17), np.float32, True)
    bad_lo = staging.piece_plan(src.size, PIECE)[-1 if where == "caller" else 2][0]
    gather = staging.gather

    def failing(s, lo, hi, out):
        if lo == bad_lo:
            raise RuntimeError(f"copy of piece {lo} failed")
        gather(s, lo, hi, out)

    monkeypatch.setattr(staging, "gather", failing)
    with pytest.raises(RuntimeError, match=f"piece {bad_lo} failed"):
        pool.fill(torch.empty(src.shape), src)
    monkeypatch.setattr(staging, "gather", gather)
    assert pool._free.qsize() == staging.PIECES_PER_THREAD * pool.threads
    dst = torch.empty(src.shape)
    pool.fill(dst, src)
    assert np.array_equal(dst.numpy(), src)


@pytest.mark.parametrize("dst", [torch.empty(5, 4, dtype=torch.float64),
                                 torch.empty(4, 4), torch.empty(4, 5).t()],
                         ids=["type", "size", "not contiguous"])
def test_fill_refuses_a_destination_that_does_not_match(pools, dst):
    with pytest.raises(ValueError, match="cannot fill"):
        pools(1, 4).fill(dst, np.zeros((5, 4), np.float32))


def test_a_fill_is_one_upload_to_the_route_contracts(pools):
    src = _source((13, 1, 17), np.float32, True)
    dst = torch.empty(src.shape)
    trace = contracts.Trace("cpu")
    with trace.resident(dst):
        pools(3, 4).fill(dst, src)
    assert (len(trace.reads), len(trace.uploads)) == (0, 1)


def test_pool_for_makes_one_pool_a_process_and_device(monkeypatch):
    monkeypatch.setattr(staging, "_POOLS", {})
    monkeypatch.setattr(staging, "PIECE_BYTES", 64)
    first = staging.pool_for("cpu")
    try:
        assert staging.pool_for("cpu") is first
        assert first.nbytes == 64 * staging.PIECES_PER_THREAD * staging.copying_threads()
        assert tracing.gauges_snapshot()[0]["clean_upload_pinned_bytes"] == first.nbytes
        monkeypatch.setattr(staging.os, "getpid", lambda: -1)   # as in a forked child
        child = staging.pool_for("cpu")
        assert child is not first and staging.pool_for("cpu") is child
    finally:
        for pool in staging._POOLS.values():
            pool.close()


def test_to_device_on_the_cpu_is_unchanged():
    snap = tracing.snapshot()
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = torch_backend.to_device(a, "cpu")
    assert np.shares_memory(t.numpy(), a)
    wide = a.astype(np.float64)
    cast = torch_backend.to_device(wide, "cpu")
    assert cast.dtype == torch.float32 and np.array_equal(cast.numpy(), a)
    ro = a.copy()
    ro.flags.writeable = False
    copied = torch_backend.to_device(ro, "cpu")
    assert not np.shares_memory(copied.numpy(), ro) and np.array_equal(copied.numpy(), a)
    assert torch_backend.to_device(t, "cpu") is t
    assert tracing.delta(snap, "clean_upload_staged") == 0


def test_only_a_large_array_of_the_type_to_a_card_takes_the_staged_route():
    card, cpu = torch.device("cuda"), torch.device("cpu")
    big = np.empty(staging.STAGED_MIN_BYTES // 4, np.float32)
    plane = np.empty((2, 4, staging.STAGED_MIN_BYTES // 8), np.float32)[:, 0]
    take = torch_backend.takes_staged_route
    assert take(big, card, torch.float32) and take(plane, card, torch.float32)
    assert not take(big[1:], card, torch.float32)                  # small: one element short
    assert not take(big, card, torch.float64)                      # a cast
    assert not take(big, cpu, torch.float32)                       # the CPU's wrap
    assert not take(torch.from_numpy(big), card, torch.float32)    # a tensor
    assert not take(np.empty(256, np.int32), card, torch.int32)    # the shifts


# --- on the card ---


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staged route copies to one")
    return torch.device("cuda")


LOFAR = (256, 1024, 1024)


def _lofar(seed=0):
    return np.random.default_rng(seed).standard_normal(LOFAR, dtype=np.float32)


@pytest.mark.card
def test_staged_upload_is_the_pageable_copy_at_lofar(card):
    a = _lofar()
    want = torch.from_numpy(a).to(card)
    snap = tracing.snapshot()
    assert torch.equal(torch_backend.to_device(a, card), want)
    stokes = np.empty((LOFAR[0], 4, *LOFAR[1:]), np.float32)
    stokes[:, 0] = a
    stokes[:, 1:] = -1.0
    assert torch.equal(torch_backend.to_device(stokes[:, 0], card), want)
    assert tracing.delta(snap, "clean_upload_staged") == 2


@pytest.mark.card
def test_upload_allocates_its_destination_alone_and_no_new_pinned_memory(card):
    a = _lofar(1)
    torch_backend.to_device(a, card)          # the pool exists from here on
    pool = staging.pool_for(card)
    pinned = [p.owner.data_ptr() for p in pool.pieces]
    host_allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = torch_backend.to_device(a, card)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base == t.nbytes
    assert staging.pool_for(card) is pool
    assert sorted(p.owner.data_ptr() for p in pool.pieces) == sorted(pinned)
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == host_allocs


@pytest.mark.card
def test_surgical_clean_with_the_staged_and_the_pageable_upload(card, monkeypatch):
    ar = make_archive(nsub=256, nchan=1024, nbin=1024, seed=42)
    cfg = CleanConfig(backend="torch")
    SurgicalCleaner(cfg).clean(ar)            # kernels built, pool made

    def run():
        snap = tracing.snapshot()
        out = SurgicalCleaner(cfg).clean(ar)
        return out, tracing.delta(snap, "clean_upload_staged")

    staged, n_staged = run()
    monkeypatch.setattr(staging, "STAGED_MIN_BYTES", 1 << 62)
    pageable, n_pageable = run()
    assert (n_staged, n_pageable) == (1, 0)
    assert np.array_equal(staged.cleaned.weights, pageable.cleaned.weights)
    assert np.array_equal(staged.result.test_results, pageable.result.test_results,
                          equal_nan=True)
    assert staged.result.loops == pageable.result.loops


@pytest.mark.card
def test_route_contracts_count_the_staged_cube_as_one_upload(card):
    cube = preprocess(make_archive(nsub=256, nchan=1024, nbin=1024, seed=2))
    snap = tracing.snapshot()
    runs, failures = contracts.run_routes("cuda", cube=cube, batch=[cube],
                                          routes={"stepwise"})
    assert not failures, failures
    findings = [f for run in runs for f in contracts.check_run(run)]
    assert not findings, [f.message for f in findings]
    # The constructor's cube: the two loop entries, kernel off and on.
    assert tracing.delta(snap, "clean_upload_staged") >= 4
