"""Torch route contracts (ICT009): host reads and the dtype lattice.

Written for the port, in place of ``iterative_cleaner_tpu/analysis/
contracts.py`` (its jaxpr/HLO checks on the traced routes).  PyTorch runs
eagerly, so there is no program to lower: each registered route runs on a
seeded cube under torch's own modes — a ``TorchFunctionMode`` sees every
call that brings a value to the host (``Tensor.item``, ``tolist``,
``numpy``, ``cpu``, ``to`` a CPU device, ``__bool__``, ``__int__``,
``__float__``, ...) and every blocking upload of a host tensor, a
``TorchDispatchMode`` sees each aten op's outputs (their dtypes, and the ops
whose output shape depends on the data: ``nonzero``, a boolean-mask index,
``masked_select``, ``unique``).  Every entry point runs with the kernel
route off and on (on the CPU "on" is the kernels' plain versions, on the
card the CUDA kernels), and two contracts are asserted:

- **host reads against a ledger** — :data:`ROUTE_HOST_READS` is the
  counterpart of the JAX package's ``ROUTE_DONATIONS``: per entry point,
  the reads and the blocking uploads it makes, each per iteration or once,
  with what it is and why it is there.  The checker fails in both
  directions: a read the ledger does not count is a sync in the hot loop on
  the card; a read it counts that vanished means the ledger (and the
  docstrings it quotes) went stale.  On the card each run is also made
  under ``torch.cuda.set_sync_debug_mode``, and the card's synchronising
  calls must be exactly the reads plus the uploads — the kinds the modes
  count apart, because a blocking upload is free on the CPU and a sync on
  the card.  A data-dependent op can sync on CUDA and look sync-free on the
  CPU; the card run settles it (``torch.nonzero_static`` in
  ``sparse_template_candidate`` is held to no sync this way).
- **dtype lattice** — no float64 or complex128 tensor on the float32
  routes: the oracle promotes three diagnostics to float64 on the host, and
  the device side of that split stays uniformly 32-bit or the masks drift.
  The ``--x64`` routes are the operator's opt-in and are not traced, as in
  the JAX package.

No donation ledger: JAX's ``ROUTE_DONATIONS`` checks buffer donation that
survives lowering, and PyTorch neither lowers a route nor donates a buffer
(a caller's tensor is never consumed; the port's substitute for XLA's
memory analysis is ``obs/memory.analyze_batch_route``).  An entry point
that fails to run is a finding, and so is a registered one that was not
run, or a run one the ledger does not register.

Runs with forensics' attribution off (``ICT_FORENSICS`` unset for the run):
it replays the oracle from fetched maps, reads the ledger does not count.
``tools_torch/ict_lint.py --contracts`` runs this on ``--device`` (cuda by
default, as every entry point of the port); ``chip_smoke.py`` runs it on
the card on the tiny cube and at 256 x 1024 x 1024.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import warnings
import weakref

from iterative_cleaner_tpu_torch.analysis.engine import Finding

#: The tiny cube: seed 2 iterates 4 times (flips 9, 1, 2, 2), so every
#: route takes its sparse template update; the batch pairs it with seed 3
#: (2 iterations), so one archive stops while the other goes on.
TINY_SHAPE = (4, 8, 64)
TINY_SEEDS = (2, 3)
#: Subints per streamed block of the chunked route on the tiny cube.
TINY_BLOCK = 2

#: 64-bit types forbidden on the float32 routes.
FORBIDDEN_DTYPES = ("torch.float64", "torch.complex128")

#: Tensor methods and torch functions that bring a value to the host.
READ_CALLS = {
    "item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__",
    "__index__", "__array__", "__format__", "__repr__", "__str__",
    "equal", "allclose", "is_nonzero",
}
#: What ``torch.cuda.set_sync_debug_mode("warn")`` says at each
#: synchronising call.
SYNC_WARNING = "called a synchronizing CUDA operation"
#: aten ops whose output shape depends on the data: the host must read it.
SHAPE_OPS = ("aten.nonzero.", "aten.masked_select.", "aten._unique.",
             "aten._unique2.", "aten.unique_dim.", "aten.unique_consecutive.")

#: How often a ledger line's transfers happen, from what a run observed.
UNITS = {
    "run": "once per run of the entry point (a call, or a whole clean)",
    "iteration": "each iteration",
    "later iteration": "each iteration after the first",
    "continuing iteration": "each iteration before the last one allowed",
    "dense pass": "each streamed template pass",
    "sparse update": "each template advanced by the sparse update",
    "archive": "each archive a rank holds",
    "archive block": "each archive's subint block on a device of this process's in a mesh",
    "staged read": "each collective operand parallel/collectives.py copied to the host",
    "staged upload": "each collective result parallel/collectives.py copied to the card",
}


@dataclasses.dataclass(frozen=True)
class HostReads:
    """One line of the ledger: ``count`` transfers of ``kind`` ("read": a
    device value to the host; "upload": a blocking host→device copy) per
    ``unit`` (:data:`UNITS`), and what they are."""

    kind: str
    count: int
    unit: str
    what: str


_FETCH = HostReads("read", 2, "iteration",
                   "the scores and the new weights to the host: a stepwise "
                   "backend returns host arrays to LoopState")
_UPLOAD_STEP = HostReads("upload", 1, "iteration",
                         "the weights the step starts from (LoopState hands "
                         "host arrays)")
_UPLOAD_CUBE = HostReads("upload", 2, "run",
                         "the cube and the original weights (the constructor; "
                         "a cube of ingest/staging.STAGED_MIN_BYTES or more is "
                         "one staged upload: its pieces' non-blocking copies, "
                         "then the last piece's blocking one, the one sync)")

#: route -> entry point -> its transfers.  Changing a route's host traffic
#: means updating its line here in the same change — the contract doing
#: its job.
ROUTE_HOST_READS: dict[str, dict[str, tuple[HostReads, ...]]] = {
    "stepwise": {
        "clean_step": (),
        "step_from_template": (),
        # torch.nonzero_static: the flipped indices at a static size.
        "sparse_template_candidate": (),
        "incremental_template": (
            HostReads("read", 1, "run",
                      "bool(ok): whether the sparse candidate may stand for "
                      "the dense rebuild (its docstring's one host read)"),),
        "TorchCleaner.step": (
            _UPLOAD_CUBE, _UPLOAD_STEP, _FETCH,
            HostReads("read", 1, "later iteration",
                      "incremental_template's decision: the sparse candidate "
                      "or the dense rebuild (iteration 1 builds densely)"),),
        "TorchCleaner.step dense": (_UPLOAD_CUBE, _UPLOAD_STEP, _FETCH),
        "TorchCleaner.step resident cube": (
            HostReads("upload", 1, "run",
                      "the original weights (the constructor; the cube is on "
                      "the device already: the device preprocess's, which "
                      "to_device passes through)"),
            _UPLOAD_STEP, _FETCH,
            HostReads("read", 1, "later iteration",
                      "incremental_template's decision: the sparse candidate "
                      "or the dense rebuild (iteration 1 builds densely)"),),
    },
    "fused": {
        "fused_clean": (
            HostReads("read", 1, "iteration",
                      "the stop flag together with the sparse-or-dense "
                      "template decision, one .tolist() (the last allowed "
                      "iteration reads the stop flag alone)"),),
        "fused_clean dense": (
            HostReads("read", 1, "iteration", "the stop flag, bool(hit)"),),
    },
    "chunked": {
        "ChunkedTorchCleaner.step": (
            HostReads("upload", 1, "run",
                      "the original weights (the constructor; the cube stays "
                      "on the host and streams through pinned buffers with "
                      "non-blocking copies, which do not synchronise)"),
            HostReads("upload", 1, "dense pass",
                      "the weights of a streamed template pass"),
            HostReads("upload", 2, "sparse update",
                      "the flipped profiles' weight changes and rows, "
                      "gathered on the host"),
            _FETCH,
            HostReads("read", 1, "sparse update",
                      "whether the sparse candidate is finite (a candidate "
                      "that is not is read, then rebuilt densely: no cube "
                      "here has one)"),),
    },
    "batch": {
        "batched_fused_clean": (
            HostReads("read", 1, "continuing iteration",
                      "active.any(): whether an archive is still iterating "
                      "(the last allowed iteration does not ask)"),),
    },
    "local": {
        "sharded_clean": (
            HostReads("upload", 2, "archive block",
                      "the block's subints of the cube and its rows of the "
                      "original weights, from the host to its device "
                      "(shard_batch; the slice's first device assembles the "
                      "whole weights from the blocks, device to device)"),
            HostReads("read", 1, "continuing iteration",
                      "active.any() over every dp slice's flags, gathered on "
                      "the mesh's first device (the last allowed iteration "
                      "does not ask)"),
            HostReads("read", 1, "run",
                      "every slice's scores, weights, loops, converged and "
                      "iterations, met on the first device, in one fetch"),),
    },
    "ranks": {
        "sharded_clean": (
            HostReads("upload", 2, "archive",
                      "the rank's subints of the cube and the archive's whole "
                      "original weights (shard_batch)"),
            HostReads("read", 1, "continuing iteration",
                      "active.any() of the rank's dp slice: the same on every "
                      "rank of it, from the same gathered maps (the last "
                      "allowed iteration does not ask)"),
            HostReads("read", 1, "run",
                      "every slice's results to the host (gather_results: "
                      "under gloo before the gather, under nccl after it)"),
            HostReads("read", 1, "staged read",
                      "a collective's operand to the host under gloo with the "
                      "rank on a card (the template sent on or broadcast, the "
                      "maps gathered): gloo takes host tensors"),
            HostReads("upload", 1, "staged upload",
                      "a collective's result back to the card under gloo (the "
                      "template received or broadcast, the gathered maps)"),),
    },
    "rank_devices": {
        "sharded_clean": (
            HostReads("upload", 2, "archive block",
                      "the block's subints of the cube and its rows of the "
                      "original weights, from the host to the rank's device "
                      "(shard_batch; the rank's first device of a slice "
                      "assembles the whole weights from its blocks, and from "
                      "the slice's other ranks where it spans them)"),
            HostReads("read", 1, "continuing iteration",
                      "active.any() over the flags of the rank's slices, met "
                      "on its first device: the same on every rank of a slice "
                      "that spans ranks, from the same gathered maps (the last "
                      "allowed iteration does not ask)"),
            HostReads("read", 1, "run",
                      "every slice's results to the host (gather_results: "
                      "under gloo before the gather, under nccl after it)"),
            HostReads("read", 1, "staged read",
                      "a collective's operand to the host under gloo with the "
                      "rank on a card, where a slice spans ranks (the set-up's "
                      "weights and each iteration's maps gathered, the "
                      "template sent on or broadcast)"),
            HostReads("upload", 1, "staged upload",
                      "a collective's result back to the card under gloo (the "
                      "gathered weights and maps, the template received or "
                      "broadcast)"),),
    },
}


def _finding(route: str, label: str, kind: str, message: str) -> Finding:
    # ``kind`` goes into the snippet — the fingerprint basis — so
    # baselining one violation class for an entry point can never suppress
    # a different one there.
    return Finding(rule="ICT009/route-contract",
                   path="iterative_cleaner_tpu_torch/analysis/contracts.py",
                   line=1, snippet=f"{route}:{label}:{kind}",
                   message=f"[{route}/{label}] {message}")


def expected_counts(lines: tuple[HostReads, ...], units: dict) -> dict[str, int]:
    """kind -> transfers the ledger ``lines`` predict for a run's
    ``units``."""
    out = {"read": 0, "upload": 0}
    for line in lines:
        out[line.kind] += line.count * int(units.get(line.unit, 0))
    return out


# --- the modes ---


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))


def _site() -> str:
    """``<module path>:<function>`` of the innermost package frame outside
    this analysis package: where the route made the call."""
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(_PKG_DIR) and not path.startswith(_ANALYSIS_DIR):
            rel = os.path.relpath(path, os.path.dirname(_PKG_DIR)).replace(os.sep, "/")
            return f"{rel}:{frame.f_code.co_qualname}"
        frame = frame.f_back
    return "<outside the package>"


def _target_device(args, kwargs):
    """The device a ``Tensor.to`` call names (positional or keyword, or a
    tensor's), or None for a dtype-only conversion."""
    import torch

    for cand in [kwargs.get("device"), *args[1:2]]:
        if isinstance(cand, torch.Tensor):
            return cand.device
        if isinstance(cand, (str, torch.device)):
            return torch.device(cand)
        if isinstance(cand, int) and not isinstance(cand, bool):
            return torch.device("cuda", cand)
    return None


class Trace:
    """The modes of one run: ``reads`` and ``uploads`` (each a site),
    ``f64`` (ops that made a 64-bit float), and on the card ``syncs`` (the
    site of each synchronising call the card reported).

    A tensor made by a torch call during the run, or handed to the route as
    an input on its device (:meth:`resident`), lives on the route's device,
    whichever device that is: a read of it is a device read.  Any other
    (``torch.from_numpy`` of a host array) is host data, and its copy to the
    device an upload."""

    def __init__(self, device) -> None:
        import torch

        self.device = torch.device(device)
        self.reads: list[str] = []
        self.uploads: list[str] = []
        self.f64: set[str] = set()
        self.syncs: list[str] | None = None
        self._made: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
        self._stack = contextlib.ExitStack()
        self._caught: list | None = None     # the card's sync warnings, as they come
        self._sync_sites: list[str] = []

    def _on_device(self, t) -> bool:
        return t.device.type != "cpu" or id(t) in self._made

    def resident(self, *tensors) -> "Trace":
        """Count ``tensors`` — a route's inputs, put on its device before
        the run — as device tensors."""
        self._note_made(tensors)
        return self

    def _note_made(self, out) -> None:
        import torch

        if isinstance(out, torch.Tensor):
            self._made[id(out)] = out
        elif isinstance(out, (tuple, list)):
            for o in out:
                self._note_made(o)

    def transfer(self, name: str, args, kwargs) -> str | None:
        """"read", "upload" or None: what the torch call ``name`` on
        ``args`` moves between the host and the device."""
        import torch

        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors:
            # A factory from host data straight onto the device.
            return "upload" if name in ("tensor", "as_tensor") and "device" in kwargs else None
        if name in READ_CALLS:
            return "read" if any(self._on_device(t) for t in tensors) else None
        if kwargs.get("non_blocking", False):
            return None   # from pinned memory: no synchronisation
        first = self._on_device(tensors[0])
        if name in ("to", "cuda"):
            dev = _target_device(args, kwargs) if name == "to" else torch.device("cuda")
            if dev is None:
                return None
            if dev.type == "cpu" and first:
                return "read"
            return None if first else "upload"
        if name in ("copy_", "__setitem__") and len(tensors) >= 2:
            second = self._on_device(tensors[-1])
            if first != second:
                return "upload" if first else "read"
        return None

    def _function_mode(self):
        from torch.overrides import TorchFunctionMode

        trace = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                caught = trace._caught
                before = len(caught) if caught is not None else 0
                name = getattr(func, "__name__", "")
                kind = trace.transfer(name, args, kwargs)
                out = func(*args, **kwargs)
                if caught is not None and len(caught) > before:
                    site = _site()
                    trace._sync_sites += [site for w in caught[before:]
                                          if SYNC_WARNING in str(w.message)]
                if kind == "read":
                    trace.reads.append(_site())
                    trace._made.pop(id(out), None)   # a host copy now
                    return out
                if kind == "upload":
                    trace.uploads.append(_site())
                if not name.startswith("lift_fresh"):
                    # torch.from_numpy lifts the host array through
                    # lift_fresh: its tensor stays host data.
                    trace._note_made(out)
                return out

        return Mode()

    def _dispatch_mode(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        trace = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = str(func)
                outs = out if isinstance(out, (tuple, list)) else (out,)
                for o in outs:
                    if isinstance(o, torch.Tensor) and str(o.dtype) in FORBIDDEN_DTYPES:
                        trace.f64.add(f"{name}:{str(o.dtype)[6:]} at {_site()}")
                if name.startswith(SHAPE_OPS) or (
                        name.startswith("aten.index.Tensor") and any(
                            isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                            for i in (args[1] if len(args) > 1 else ()) or ())):
                    trace.reads.append(_site())
                return out

        return Mode()

    def __enter__(self) -> "Trace":
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # ict: backend-init-ok(the route's tensors are on the card: CUDA is live)
            self._caught = self._stack.enter_context(warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")  # ict: backend-init-ok(the route's tensors are on the card: CUDA is live)
            self._stack.callback(torch.cuda.set_sync_debug_mode, 0)
            self._stack.callback(self._collect_syncs)
        self._stack.enter_context(self._function_mode())
        self._stack.enter_context(self._dispatch_mode())
        return self

    def _collect_syncs(self) -> None:
        """Each sync at the site of the torch call that made it; one made
        outside any torch call (another thread's, say) at the line the card
        names.  Only the per-call warning counts: turning the mode on also
        warns, once, that it "does not yet detect all synchronizing
        operations"."""
        total = [w for w in self._caught if SYNC_WARNING in str(w.message)]
        rest = total[len(self._sync_sites):]
        self.syncs = self._sync_sites + [f"{os.path.basename(w.filename)}:{w.lineno}"
                                         for w in rest]
        self._caught = None

    def __exit__(self, *exc) -> None:
        self._stack.close()


# --- the routes ---


@dataclasses.dataclass
class RouteRun:
    """One entry point's run: its ``units`` (:data:`UNITS`), its trace and
    what the ledger predicts for those units."""

    route: str
    label: str
    kernel: bool
    units: dict
    trace: Trace
    expected: dict

    @property
    def name(self) -> str:
        return f"{self.label} [{'kernel' if self.kernel else 'plain'}]"


def tiny_cube(seed: int = TINY_SEEDS[0]):
    """The seeded, preprocessed tiny cube (D, w0) the contracts run on."""
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    nsub, nchan, nbin = TINY_SHAPE
    return preprocess(make_archive(nsub=nsub, nchan=nchan, nbin=nbin, seed=seed),
                      prefer_native=False)


def _entry_points(D, w0, Db, w0b, device, block):
    """(route, label, run) for every registered entry point; ``run(trace,
    kernel)`` sets up outside ``trace``, drives the entry point inside it
    and returns the run's units."""
    import torch

    from iterative_cleaner_tpu_torch.backends import torch_backend as tb
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import LoopState
    from iterative_cleaner_tpu_torch.ops.template import build_template
    from iterative_cleaner_tpu_torch.parallel.chunked import ChunkedTorchCleaner
    from iterative_cleaner_tpu_torch.parallel.sharded import batched_fused_clean

    cfg = CleanConfig(backend="torch")
    ct, st = float(cfg.chanthresh), float(cfg.subintthresh)
    pr, max_iter = tuple(cfg.pulse_region), int(cfg.max_iter)

    def on_device():
        Dt, wt = tb.to_device(D, device), tb.to_device(w0, device)
        return Dt, wt, wt != 0

    def step_weights(Dt, wt, vt):
        """Iteration 1's new weights: a state the later calls start from."""
        return tb.clean_step(Dt, wt, vt, wt, ct, st, pulse_region=pr)[1]

    def one_call(fn):
        def run(trace, kernel):
            Dt, wt, vt = on_device()
            new_w = step_weights(Dt, wt, vt)
            T = build_template(Dt, wt)
            with trace.resident(Dt, wt, vt, new_w, T):
                fn(Dt, wt, vt, new_w, T, kernel)
            return {"run": 1}
        return run

    def loop(backend_of, incremental):
        def run(trace, kernel):
            c = cfg.replace(kernel=kernel, incremental_template=incremental)
            taken = tb.sparse_template_candidate.taken
            with trace:
                backend = backend_of(c)
                state = LoopState.start(w0)
                state.run(backend, c.max_iter, timed=False)
            n = len(state.infos)
            return {"run": 1, "iteration": n, "later iteration": n - 1,
                    "dense pass": getattr(backend, "template_passes", 0),
                    "sparse update": tb.sparse_template_candidate.taken - taken}
        return run

    def resident(trace, kernel):
        Dt = tb.to_device(D, device)
        c = cfg.replace(kernel=kernel)
        taken = tb.sparse_template_candidate.taken
        with trace.resident(Dt):
            backend = tb.TorchCleaner(Dt, w0, c, device=device)
            state = LoopState.start(w0)
            state.run(backend, c.max_iter, timed=False)
        n = len(state.infos)
        return {"run": 1, "iteration": n, "later iteration": n - 1,
                "sparse update": tb.sparse_template_candidate.taken - taken}

    def fused(incremental):
        def run(trace, kernel):
            Dt, wt, vt = on_device()
            with trace.resident(Dt, wt, vt):
                out = tb.fused_clean(Dt, wt, vt, ct, st, max_iter=max_iter, pulse_region=pr,
                                     use_kernel=kernel, incremental=incremental)
            return {"run": 1, "iteration": out[4]}
        return run

    def batch(trace, kernel):
        Dbt = torch.stack([tb.to_device(d, device) for d in Db])
        wbt = torch.stack([tb.to_device(w, device) for w in w0b])
        vbt = wbt != 0
        with trace.resident(Dbt, wbt, vbt):
            out = batched_fused_clean(Dbt, wbt, vbt, ct, st, max_iter=max_iter,
                                      pulse_region=pr, use_kernel=kernel)
        n = int(out[4].max())
        return {"run": 1, "continuing iteration": min(n, max_iter - 1)}

    def local(trace, kernel):
        from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh
        from iterative_cleaner_tpu_torch.parallel.sharded import sharded_clean

        mesh = make_mesh(devices=[device, device], dp=1, sp=2)
        with trace:
            out = sharded_clean([D], [w0], cfg.replace(kernel=kernel), mesh)
        n = int(out[2][0]) if out[3][0] else max_iter
        return {"run": 1, "archive block": 2, "continuing iteration": min(n, max_iter - 1)}

    def ranks(k):
        def run(trace, kernel):
            from iterative_cleaner_tpu_torch.parallel import collectives
            from iterative_cleaner_tpu_torch.parallel.sharded import sharded_clean

            with _rank_group(device, k) as mesh:
                collectives.traffic.reset()
                with trace:
                    out = sharded_clean([D], [w0], cfg.replace(kernel=kernel), mesh)
            n = int(out[2][0]) if out[3][0] else max_iter
            return {"run": 1, "archive": 1, "archive block": k,
                    "continuing iteration": min(n, max_iter - 1),
                    "staged read": collectives.traffic.staged_reads,
                    "staged upload": collectives.traffic.staged_uploads}
        return run

    return [
        ("stepwise", "clean_step", one_call(
            lambda Dt, wt, vt, new_w, T, k: tb.clean_step(
                Dt, wt, vt, new_w, ct, st, pulse_region=pr, use_kernel=k))),
        ("stepwise", "step_from_template", one_call(
            lambda Dt, wt, vt, new_w, T, k: tb.step_from_template(
                Dt, wt, vt, T, ct, st, pulse_region=pr, use_kernel=k))),
        ("stepwise", "sparse_template_candidate", one_call(
            lambda Dt, wt, vt, new_w, T, k: tb.sparse_template_candidate(Dt, T, wt, new_w))),
        ("stepwise", "incremental_template", one_call(
            lambda Dt, wt, vt, new_w, T, k: tb.incremental_template(Dt, T, wt, new_w))),
        ("stepwise", "TorchCleaner.step", loop(
            lambda c: tb.TorchCleaner(D, w0, c, device=device), True)),
        ("stepwise", "TorchCleaner.step dense", loop(
            lambda c: tb.TorchCleaner(D, w0, c, device=device), False)),
        ("stepwise", "TorchCleaner.step resident cube", resident),
        ("fused", "fused_clean", fused(True)),
        ("fused", "fused_clean dense", fused(False)),
        ("chunked", "ChunkedTorchCleaner.step", loop(
            lambda c: ChunkedTorchCleaner(D, w0, c, block=block, device=device), True)),
        ("batch", "batched_fused_clean", batch),
        ("local", "sharded_clean", local),
        ("ranks", "sharded_clean", ranks(1)),
        ("rank_devices", "sharded_clean", ranks(2)),
    ]


@contextlib.contextmanager
def _rank_group(device, k=1):
    """A mesh over the ranks of the default process group with this rank
    holding ``device`` ``k`` times (with ``k`` 2, one ``sp=2`` slice on
    the rank's two logical devices): the process's own group, else a
    one-rank ``gloo`` group made for the run (an in-memory store) and
    destroyed after it.  Under gloo on a card the collectives stage
    through the host."""
    import torch
    import torch.distributed as dist

    from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh

    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh(*((k, 1, k) if k > 1 else ()), group=dist.group.WORLD,
                        devices=[torch.device(device)] * k)
    finally:
        if made:
            dist.destroy_process_group()


@contextlib.contextmanager
def _forensics_off():
    saved = os.environ.pop("ICT_FORENSICS", None)
    try:
        yield
    finally:
        if saved is not None:
            os.environ["ICT_FORENSICS"] = saved


def run_routes(device="cpu", cube=None, batch=None, block: int | None = None,
               routes=None) -> tuple[list[RouteRun], list[Finding]]:
    """Run every registered entry point (or those of ``routes``) on
    ``device`` with the kernel route off and on: on ``cube`` (D, w0), by
    default :func:`tiny_cube`, the batch on ``batch`` (a sequence of (D,
    w0)), by default the tiny seeds, the chunked route in ``block``-subint
    blocks.  Returns the runs and the entry points that failed to run, as
    findings."""
    D, w0 = tiny_cube() if cube is None else cube
    pairs = [tiny_cube(s) for s in TINY_SEEDS] if batch is None else list(batch)
    block = TINY_BLOCK if block is None else int(block)
    runs, failures = [], []
    with _forensics_off():
        for route, label, run in _entry_points(D, w0, [p[0] for p in pairs],
                                               [p[1] for p in pairs], device, block):
            if routes is not None and route not in routes:
                continue
            for kernel in (False, True):
                trace = Trace(device)
                try:
                    units = run(trace, kernel)
                except Exception as exc:  # noqa: BLE001 — surfaced as a finding
                    failures.append(_finding(
                        route, label, "run-failure",
                        f"the entry point failed to run (kernel {kernel}): "
                        f"{type(exc).__name__}: {exc}"))
                    continue
                lines = ROUTE_HOST_READS.get(route, {}).get(label, ())
                runs.append(RouteRun(route, label, kernel, units, trace,
                                     expected_counts(lines, units)))
    return runs, failures


def check_run(run: RouteRun) -> list[Finding]:
    """The contracts on one run: reads and uploads against the ledger, the
    card's syncs against both, no 64-bit float."""
    out = []
    t = run.trace
    for kind, got in (("read", t.reads), ("upload", t.uploads)):
        want = run.expected[kind]
        if len(got) != want:
            out.append(_finding(
                run.route, run.name, f"{kind}s",
                f"{len(got)} host {kind}s where the ledger counts {want} for "
                f"{run.units}: {sorted(set(got))} — "
                f"{'a transfer the ledger does not count' if len(got) > want else 'a counted transfer vanished'}; "
                f"update ROUTE_HOST_READS only with the intentional change"))
    if t.syncs is not None and len(t.syncs) != len(t.reads) + len(t.uploads):
        out.append(_finding(
            run.route, run.name, "syncs",
            f"{len(t.syncs)} CUDA synchronisations ({t.syncs}) against "
            f"{len(t.reads)} reads and {len(t.uploads)} uploads the modes saw: "
            f"a sync the ledger does not predict"))
    if t.f64:
        out.append(_finding(
            run.route, run.name, "dtype",
            f"64-bit tensors on a float32 route ({sorted(t.f64)[:4]}): the "
            f"device side of the oracle's f64-promotion split must stay "
            f"uniformly 32-bit"))
    return out


def check_routes(device="cpu", cube=None, batch=None, block=None) -> list[Finding]:
    """All contracts on all routes; an entry point that does not run, or a
    registered one that did not, or a run one that is not registered, is a
    finding too (the checker never skips one silently)."""
    runs, findings = run_routes(device, cube, batch, block)
    seen = set()
    for run in runs:
        seen.add((run.route, run.label))
        if run.label not in ROUTE_HOST_READS.get(run.route, {}):
            findings.append(_finding(
                run.route, run.label, "unregistered",
                "entry point run but not in ROUTE_HOST_READS — register its "
                "host transfers"))
            continue
        findings.extend(check_run(run))
    failed = {tuple(f.snippet.split(":")[:2]) for f in findings
              if f.snippet.endswith(":run-failure")}
    for route, labels in sorted(ROUTE_HOST_READS.items()):
        for label in labels:
            if (route, label) not in seen and (route, label) not in failed:
                findings.append(_finding(
                    route, label, "untraced",
                    "entry point registered in ROUTE_HOST_READS but not run "
                    "— add it to _entry_points()"))
    return findings
