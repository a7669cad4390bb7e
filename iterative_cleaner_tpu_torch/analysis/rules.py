"""AST source rules: the project's load-bearing conventions, mechanised.

The port of ``iterative_cleaner_tpu/analysis/rules.py``, re-aimed at the
port's tree and at torch's spellings.  Rule catalog:

- **ICT001/device-init** — a call that can start CUDA's first
  initialisation (:data:`CUDA_INIT_ATTRS`: a wedged driver hangs it
  process-wide, with no exception and no timeout) is allowed only in
  ``utils/device_probe.py`` (the probe and the watchdog), lexically inside
  a ``with init_watchdog(...)`` block, or annotated
  ``# ict: backend-init-ok(<how it is guarded>)`` — where CUDA is already
  live (operands on the card, a ``torch.cuda.is_initialized()`` gate) the
  annotation says so.
- **ICT002/mask-f64** — no 64-bit float/complex dtypes in mask-affecting
  modules (``ops/``, ``core/``, ``parallel/``, ``online/finalize.py``, both
  backends) without ``# ict: f64-ok(<reason>)``: the oracle's numpy.ma f64
  promotion is *its* defined behavior; the float32 routes must stay
  uniformly 32-bit or the masks drift.  Torch spells the type
  ``torch.float64``, ``torch.double``, ``torch.complex128`` or
  ``torch.cdouble``, and a tensor's ``.double()``; numpy ``np.float64`` and
  ``"float64"`` strings, as in the JAX rule.  The ``--x64`` routes are the
  operator's opt-in, so their float64 lines carry the annotation.
- **ICT003/mask-nondet** — no wall-clock (``time.time``), RNG
  (``random``/``np.random``/``uuid``/``secrets``/``os.urandom``, torch's
  unseeded draws — :data:`TORCH_RNG_CALLS` without ``generator=`` — and
  ``torch.random.*``) or unordered accumulation (:data:`ATOMIC_SCATTERS`:
  on CUDA ``index_add_``, ``scatter_add_`` and ``index_put_(...,
  accumulate=True)`` add with atomics, in no fixed order, so a float sum
  changes from run to run) in mask-affecting modules without
  ``# ict: nondet-ok(<reason>)``: replay determinism (spool resume, repro
  bundles, fuzz seeds) depends on the mask path being a pure function of
  (cube, weights, config).  No mask module scatters today; the rule keeps
  it so.
- **ICT005/metric-name** — literal metric/phase names handed to the
  :mod:`..obs.tracing` registries must fit the Prometheus grammar once
  the ``ict_`` prefix lands (``[a-z][a-z0-9_]*``), and label keys
  likewise.
- **ICT005/metric-registration** — one family, one kind: a name used as
  both counter and gauge (or both flat and labeled) would render twice
  under the same ``ict_`` family on ``/metrics``; label-key sets per
  family must be consistent across call sites.

Two JAX rule ids are reserved and have no torch target: **ICT004**
(``bench.py``'s exit paths, ``analysis/bench_cfg.py``) waits for the port's
benchmark tool, and **ICT006** (numpy calls inside a jit-traced body) has
nothing to trace — the port has no ``torch.jit`` or ``torch.compile`` body:
PyTorch runs eagerly, and a numpy call there is a host call like any other
(the route contracts, :mod:`.contracts`, count the host reads).  The race
rules (ICT007/ICT008) live in :mod:`.races`.
"""

from __future__ import annotations

import ast
import re

from iterative_cleaner_tpu_torch.analysis.engine import Finding, SourceFile

#: Modules whose code can affect a flag mask: every dtype / determinism
#: rule applies here.
MASK_MODULE_PREFIXES = (
    "iterative_cleaner_tpu_torch/ops/",
    "iterative_cleaner_tpu_torch/core/",
    "iterative_cleaner_tpu_torch/parallel/",
)
MASK_MODULES_EXACT = (
    "iterative_cleaner_tpu_torch/online/finalize.py",
    "iterative_cleaner_tpu_torch/backends/torch_backend.py",
    "iterative_cleaner_tpu_torch/backends/numpy_backend.py",
)

#: The one module allowed to start CUDA unguarded — it IS the guard.
DEVICE_INIT_ALLOWED = ("iterative_cleaner_tpu_torch/utils/device_probe.py",)

#: ``torch.cuda`` calls that can start CUDA's first initialisation: every
#: one that runs ``torch.cuda._lazy_init`` (it creates the context; the
#: probe's ``torch.cuda.init()`` and the watchdog's liveness,
#: ``torch.cuda.is_initialized()``, are about exactly this step) — ``init``,
#: ``current_device`` and every call that defaults its device to it, the
#: ``device`` context manager (its entry sets the device), streams,
#: ``synchronize`` — and ``device_count``, which loads the driver to count
#: the devices.  Not counted: ``is_available``, though it asks the same
#: device count and so can block in a wedged driver's load: it creates no
#: context (``is_initialized()`` stays False after it) and it is the gate
#: every entry point asks first (``backends/torch_backend.resolve_device``
#: refuses a CUDA request without a card), so flagging it would flag the
#: gate; ``is_initialized``; the allocator's statistics
#: (``memory_stats``, ``memory_allocated``, ``max_memory_allocated``,
#: ``memory_reserved``) and ``empty_cache``, which return at once before
#: the first initialisation; and ``Event``/``Stream`` objects.
CUDA_INIT_ATTRS = {
    "init", "current_device", "set_device", "device", "device_count",
    "get_device_properties", "get_device_name", "get_device_capability",
    "mem_get_info", "current_stream", "default_stream", "synchronize",
    "reset_peak_memory_stats", "set_sync_debug_mode", "get_sync_debug_mode",
    "cudart", "set_per_process_memory_fraction", "ipc_collect",
    "can_device_access_peer",
}

METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
LABEL_KEY_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

#: tracing-registry entry points -> metric kind ("counter" / "gauge") and
#: whether the family takes labels
#: (``iterative_cleaner_tpu_torch/obs/tracing.py``).
REGISTRY_FNS = {
    "count": ("counter", False),
    "count_labeled": ("counter", True),
    "observe_phase": ("counter", False),
    "phase": ("counter", False),
    "set_gauge": ("gauge", False),
    "set_gauge_labeled": ("gauge", True),
    "max_gauge_labeled": ("gauge", True),
}

NONDET_EXACT = {"time.time", "time.time_ns", "os.urandom"}
NONDET_PREFIXES = ("random.", "numpy.random.", "uuid.", "secrets.",
                   "torch.random.")

#: torch's draws from the process-wide generator: nondeterministic unless
#: the call names its own ``generator=``.
TORCH_RNG_CALLS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
}

#: Accumulating scatters (method or ``torch.`` function) that CUDA runs
#: with atomic adds: duplicate indices sum in no fixed order.
#: ``index_put``/``put`` accumulate only with ``accumulate=True``.
ATOMIC_SCATTERS = {"index_add", "index_add_", "scatter_add", "scatter_add_"}
ACCUMULATE_SCATTERS = {"index_put", "index_put_", "put", "put_"}


def _import_canonical_map(tree: ast.AST) -> dict[str, str]:
    """alias -> canonical dotted prefix, so import style cannot evade a
    name-based rule: ``from time import time`` -> {'time': 'time.time'},
    ``import numpy.random as npr`` -> {'npr': 'numpy.random'},
    ``import numpy as np`` -> {'np': 'numpy'}."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}")
    return out


def _canonical_call_name(node: ast.Call, aliases: dict[str, str]) -> str:
    """The call target's dotted name with its leading alias resolved to
    the canonical module path ('' when unresolvable)."""
    name = dotted_name(node.func)
    if not name:
        return ""
    head, _, rest = name.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def dotted_name(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_mask_module(path: str) -> bool:
    return (path.startswith(MASK_MODULE_PREFIXES)
            or path in MASK_MODULES_EXACT)


# --- ICT001: guarded CUDA init ---


def _watchdog_guarded_lines(tree: ast.AST) -> set[int]:
    """Line numbers lexically inside a ``with init_watchdog(...)`` block."""
    guarded: set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            call = item.context_expr
            if (isinstance(call, ast.Call)
                    and (dotted_name(call.func) or "").endswith(
                        "init_watchdog")):
                guarded.update(range(node.lineno, node.end_lineno + 1))
    return guarded


def rule_device_init(sf: SourceFile) -> list[Finding]:
    if sf.path in DEVICE_INIT_ALLOWED or sf.tree is None:
        return []
    guarded = _watchdog_guarded_lines(sf.tree)
    # Canonicalised through the import table, so `from torch import cuda`
    # or `from torch.cuda import synchronize as s` cannot evade the rule.
    aliases = _import_canonical_map(sf.tree)
    out = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _canonical_call_name(node, aliases)
        head, _, attr = name.rpartition(".")
        if head != "torch.cuda" or attr not in CUDA_INIT_ATTRS:
            continue
        if node.lineno in guarded:
            continue
        if sf.annotation(node.lineno, "backend-init-ok") is not None:
            continue
        out.append(sf.finding(
            "ICT001/device-init", node.lineno,
            f"'{name}()' can start CUDA's first initialisation, which a "
            f"wedged driver hangs process-wide; guard it via "
            f"utils/device_probe.py (ensure_responsive_backend / "
            f"init_watchdog) and annotate "
            f"'# ict: backend-init-ok(<guard, or why CUDA is live here>)'"))
    return out


# --- ICT002: no 64-bit floats on the mask path ---


#: numpy's and torch's names of the 64-bit float and complex types (an
#: attribute or a bare name; ``x.double()`` is the attribute ``double``).
_F64_NAMES = ("float64", "complex128", "double", "cdouble")


def _string_dtype_64(node: ast.Call) -> str | None:
    """A 64-bit dtype smuggled in as a string: ``.astype("float64")``,
    ``dtype="float64"`` keywords, ``np.dtype("complex128")``."""
    def is64(n):
        return (isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value in _F64_NAMES)

    callee = (node.func.attr if isinstance(node.func, ast.Attribute)
              else getattr(node.func, "id", ""))
    if callee in ("astype", "dtype", "view") and node.args and is64(node.args[0]):
        return node.args[0].value
    for kw in node.keywords:
        if kw.arg == "dtype" and is64(kw.value):
            return kw.value.value
    return None


def rule_mask_f64(sf: SourceFile) -> list[Finding]:
    if not is_mask_module(sf.path) or sf.tree is None:
        return []
    out = []
    for node in ast.walk(sf.tree):
        name = None
        if isinstance(node, ast.Attribute) and node.attr in _F64_NAMES:
            name = dotted_name(node) or node.attr
        elif isinstance(node, ast.Name) and node.id in _F64_NAMES:
            name = node.id
        elif isinstance(node, ast.Call):
            smuggled = _string_dtype_64(node)
            if smuggled is not None:
                name = f'"{smuggled}"'
        if name is None:
            continue
        if sf.annotation(node.lineno, "f64-ok") is not None:
            continue
        out.append(sf.finding(
            "ICT002/mask-f64", node.lineno,
            f"64-bit dtype '{name}' in a mask-affecting module: the "
            f"float32 routes must stay uniformly 32-bit for mask parity; "
            f"if deliberate (oracle-side promotion, the --x64 opt-in), "
            f"annotate '# ict: f64-ok(<reason>)'"))
    return out


# --- ICT003: determinism of the mask path ---


def _nondet_call(node: ast.Call, name: str) -> str | None:
    """Why ``node`` (canonical name ``name``) is nondeterministic, or
    None."""
    if name in NONDET_EXACT or name.startswith(NONDET_PREFIXES):
        return "a wall-clock or RNG call"
    kwargs = {kw.arg for kw in node.keywords}
    if name in TORCH_RNG_CALLS and "generator" not in kwargs:
        return "a draw from torch's process-wide generator (no generator=)"
    attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
    if attr in ATOMIC_SCATTERS:
        return "an accumulating scatter (atomic adds on CUDA, no fixed order)"
    if attr in ACCUMULATE_SCATTERS and any(
            kw.arg == "accumulate" and not (isinstance(kw.value, ast.Constant)
                                            and kw.value.value is False)
            for kw in node.keywords):
        return "an accumulating scatter (atomic adds on CUDA, no fixed order)"
    return None


def rule_mask_nondet(sf: SourceFile) -> list[Finding]:
    if not is_mask_module(sf.path) or sf.tree is None:
        return []
    aliases = _import_canonical_map(sf.tree)
    out = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        # Canonicalized through the import table, so `from time import
        # time` / `import numpy.random as npr` cannot evade the rule.
        name = _canonical_call_name(node, aliases)
        why = _nondet_call(node, name)
        if why is None:
            continue
        if sf.annotation(node.lineno, "nondet-ok") is not None:
            continue
        shown = name or (dotted_name(node.func) or "?")
        out.append(sf.finding(
            "ICT003/mask-nondet", node.lineno,
            f"nondeterministic call '{shown}()' ({why}) in a mask-affecting "
            f"module: masks must be a pure function of (cube, weights, "
            f"config) for replay/resume/audit determinism; if it cannot "
            f"reach a mask, annotate '# ict: nondet-ok(<reason>)'"))
    return out


# --- ICT005: Prometheus metric grammar + single registration ---


def _registry_calls(sf: SourceFile):
    """Yield (node, fn_name, kind, labeled) for tracing-registry calls."""
    if sf.tree is None:
        return
    in_tracing = sf.path.endswith("obs/tracing.py")
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = None
        if isinstance(node.func, ast.Attribute):
            base = node.func.value
            if (isinstance(base, ast.Name) and "tracing" in base.id
                    and node.func.attr in REGISTRY_FNS):
                fn = node.func.attr
        elif (isinstance(node.func, ast.Name) and in_tracing
                and node.func.id in REGISTRY_FNS):
            fn = node.func.id
        if fn is not None:
            kind, labeled = REGISTRY_FNS[fn]
            yield node, fn, kind, labeled


def rule_metric_grammar(sf: SourceFile) -> list[Finding]:
    out = []
    for node, fn, _kind, labeled in _registry_calls(sf):
        if not node.args:
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            if not METRIC_NAME_RE.match(first.value):
                out.append(sf.finding(
                    "ICT005/metric-name", node.lineno,
                    f"metric/phase name {first.value!r} (via {fn}) breaks "
                    f"the Prometheus grammar once prefixed 'ict_' — want "
                    f"[a-z][a-z0-9_]*"))
        if labeled and len(node.args) > 1 and isinstance(node.args[1], ast.Dict):
            for key in node.args[1].keys:
                if (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)
                        and not LABEL_KEY_RE.match(key.value)):
                    out.append(sf.finding(
                        "ICT005/metric-name", node.lineno,
                        f"label key {key.value!r} (via {fn}) breaks the "
                        f"Prometheus label grammar [a-z_][a-z0-9_]*"))
    return out


def rule_metric_registration(files: list[SourceFile]) -> list[Finding]:
    """Cross-file: one family name, one (kind, labeledness, label-key set).

    ``observe_phase``/``phase`` families are checked against each other
    and against flat counters (they share the ``ict_<name>_s/_n``
    namespace); a family seen as both counter and gauge, or both flat and
    labeled, would collide in the rendered exposition."""
    seen: dict[str, tuple[str, bool, tuple, SourceFile, int]] = {}
    out: list[Finding] = []
    for sf in files:
        for node, fn, kind, labeled in _registry_calls(sf):
            if not node.args:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                continue
            name = first.value
            keys: tuple = ()
            if labeled and len(node.args) > 1 and isinstance(
                    node.args[1], ast.Dict):
                keys = tuple(sorted(
                    k.value for k in node.args[1].keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)))
            prior = seen.get(name)
            if prior is None:
                seen[name] = (kind, labeled, keys, sf, node.lineno)
                continue
            pkind, plabeled, pkeys, psf, pline = prior
            if (kind, labeled) != (pkind, plabeled):
                out.append(sf.finding(
                    "ICT005/metric-registration", node.lineno,
                    f"metric family {name!r} registered as "
                    f"{'labeled ' if labeled else ''}{kind} here but as "
                    f"{'labeled ' if plabeled else ''}{pkind} at "
                    f"{psf.path}:{pline} — one family, one kind"))
            elif labeled and keys and pkeys and keys != pkeys:
                out.append(sf.finding(
                    "ICT005/metric-registration", node.lineno,
                    f"metric family {name!r} uses label keys "
                    f"{list(keys)} here but {list(pkeys)} at "
                    f"{psf.path}:{pline} — label sets must match"))
    return out


def run_source_rules(files: list[SourceFile]) -> list[Finding]:
    """Every per-file rule plus the cross-file registration check."""
    from iterative_cleaner_tpu_torch.analysis.engine import malformed_annotations

    out: list[Finding] = []
    for sf in files:
        if sf.parse_error:
            out.append(sf.finding("ICT000/annotation-grammar", 1,
                                  f"file does not parse: {sf.parse_error}"))
            continue
        out.extend(malformed_annotations(sf))
        out.extend(rule_device_init(sf))
        out.extend(rule_mask_f64(sf))
        out.extend(rule_mask_nondet(sf))
        out.extend(rule_metric_grammar(sf))
    out.extend(rule_metric_registration(
        [sf for sf in files if not sf.parse_error]))
    return out
