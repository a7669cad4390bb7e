"""ICT007/ICT008: static race detection for the port's threaded modules.

A copy of ``iterative_cleaner_tpu/analysis/races.py`` (the catalog, both
rules and the lock-order graph unchanged), aimed at the port's tree by
:data:`RACE_SCOPE_PREFIXES`.  The serving replica runs five-plus concurrent
threads (loaders, tick, dispatch worker, shadow auditor, HTTP request
threads) — and the fleet router adds its poll loop plus its own HTTP
request threads — over shared state that lives in two shapes: module
globals (the obs registries, the kernels' launch counters and build
caches) and attributes of lock-owning classes (scheduler buckets, the job
index).  This detector makes the locking discipline *checkable*:

- **Catalog** — module-level mutable state (mutable-literal initializers,
  or any name rebound via ``global`` from a function) and, in *concurrent
  classes* (classes that construct a ``threading.Lock``/``RLock`` in
  ``__init__`` or subclass ``threading.Thread``), instance attributes
  mutated from two or more non-``__init__`` methods (the multi-writer
  heuristic: a single post-init writer is the common benign
  single-owner pattern and stays out of scope).
- **ICT007/guarded-by** — every cataloged item must carry an
  ``# ict: guarded-by(<lock>)`` annotation on its defining assignment:
  either a lock declared in the same scope (module global or ``self.``
  attribute) or ``none: <reason>`` for deliberately lock-free state
  (GIL-atomic idempotent caches, pre-thread startup writes).  For
  lock-annotated state, every mutation site must sit lexically inside a
  ``with <lock>:`` block — an unannotated or outside-the-lock write is
  exactly the class of bug the drain-manifest race was.
  When every observed mutation already sits under one consistent lock,
  the finding carries a mechanical ``--fix`` (append the annotation).
- **ICT008/lock-order** — the acquisition graph (edges: lock B acquired
  — lexically or via a resolvable same-package call chain — while lock A
  is held) must be acyclic; a cycle is a potential deadlock even if
  today's schedules never interleave it.

Static, lexical, and deliberately conservative: reads are not enforced
(snapshot-read-under-lock is a convention the annotations document, not
one AST analysis can prove), calls are resolved only within the analyzed
package (same module, same class, or an imported analyzed module), and
``queue.Queue``/``threading.Event``/contextvars are treated as
internally synchronized.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from iterative_cleaner_tpu_torch.analysis.engine import Finding, SourceFile
from iterative_cleaner_tpu_torch.analysis.rules import dotted_name

#: The packages the detector walks (repo-relative prefixes).  As in the
#: JAX package, a directory or module is in scope when it owns locks or
#: threads that the serving replica's host threads share: the service, the
#: obs registries, the fleet tier (router, registry, tenants, capacity,
#: autoscaler), the campaign orchestrator and the proving ground (its soak
#: driver and chaos drills are single-threaded by design — they drive the
#: router's tick — so their state is annotated thread-confined).  Beside
#: those directories, the port modules whose state the service's threads
#: reach through a clean: the torch backend (the sparse-update count and
#: the warm-up thread), both kernel wrappers (launch counts, the fit
#: kernel's tile counters), the nvcc build cache, the native runtime's
#: loader, the block codec, the ingest stager and the CUDA-init watchdog.
RACE_SCOPE_PREFIXES = (
    "iterative_cleaner_tpu_torch/service/",
    "iterative_cleaner_tpu_torch/obs/",
    "iterative_cleaner_tpu_torch/fleet/",
    "iterative_cleaner_tpu_torch/campaign/",
    "iterative_cleaner_tpu_torch/proving/",
    "iterative_cleaner_tpu_torch/backends/torch_backend.py",
    "iterative_cleaner_tpu_torch/ops/fused_kernels.py",
    "iterative_cleaner_tpu_torch/ops/template.py",
    "iterative_cleaner_tpu_torch/ops/cuda_build.py",
    "iterative_cleaner_tpu_torch/native.py",
    "iterative_cleaner_tpu_torch/ingest/codec.py",
    "iterative_cleaner_tpu_torch/ingest/pipeline.py",
    "iterative_cleaner_tpu_torch/utils/device_probe.py",
)

LOCK_FACTORIES = {"Lock", "RLock"}
#: Internally-synchronized (or thread-confined) constructs — exempt state.
SYNCHRONIZED_FACTORIES = {
    "Event", "Condition", "Semaphore", "BoundedSemaphore", "Barrier",
    "local", "Timer", "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
    "ContextVar", "compile", "object",
}
MUTABLE_FACTORIES = {
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict",
    "Counter", "bytearray",
}
MUTATOR_METHODS = {
    "append", "appendleft", "add", "update", "pop", "popleft", "popitem",
    "remove", "discard", "clear", "insert", "extend", "extendleft",
    "setdefault", "sort", "rotate",
}


@dataclass
class ModuleModel:
    sf: SourceFile
    modname: str                                  # e.g. "obs.flight"
    locks: set[str] = field(default_factory=set)  # module-level lock names
    import_aliases: dict[str, str] = field(default_factory=dict)
    # class name -> set of "self.X" lock attr names (X only)
    class_locks: dict[str, set[str]] = field(default_factory=dict)
    concurrent_classes: set[str] = field(default_factory=set)
    # candidate global name -> defining lineno
    global_candidates: dict[str, int] = field(default_factory=dict)
    # (class, attr) -> defining lineno in __init__
    attr_candidates: dict[tuple[str, str], int] = field(default_factory=dict)
    # (class, attr) -> sorted writer method names (non-init)
    attr_writers: dict[tuple[str, str], set[str]] = field(default_factory=dict)


def _is_constant_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):  # tuple-of-constants CONFIG
        return all(_is_constant_expr(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp):
        return _is_constant_expr(node.operand)
    if isinstance(node, ast.BinOp):
        return _is_constant_expr(node.left) and _is_constant_expr(node.right)
    return False


def _factory_of(node: ast.AST) -> str | None:
    """Trailing callable name of a Call initializer ('Lock' for
    threading.Lock(), 'deque' for collections.deque(...))."""
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name:
            return name.split(".")[-1]
    return None


def _is_mutable_init(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                         ast.ListComp, ast.SetComp)):
        return True
    factory = _factory_of(node)
    return factory in MUTABLE_FACTORIES


# --- per-module cataloging ---


def _module_name(path: str) -> str:
    # iterative_cleaner_tpu_torch/obs/flight.py -> obs.flight
    parts = path.replace(".py", "").split("/")
    return ".".join(parts[1:]) if len(parts) > 1 else parts[0]


def build_model(sf: SourceFile) -> ModuleModel:
    tree = sf.tree
    model = ModuleModel(sf=sf, modname=_module_name(sf.path))
    assert isinstance(tree, ast.Module)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                model.import_aliases[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                model.import_aliases[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}")

    # Module-level assignments.
    for stmt in tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = [t for t in stmt.targets if isinstance(t, ast.Name)]
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target] if isinstance(stmt.target, ast.Name) else []
            value = stmt.value
        else:
            continue
        factory = _factory_of(value)
        for target in targets:
            if factory in LOCK_FACTORIES:
                model.locks.add(target.id)
            elif factory in SYNCHRONIZED_FACTORIES:
                continue
            elif _is_mutable_init(value):
                model.global_candidates[target.id] = stmt.lineno

    # Names rebound via `global` in any function are shared module state
    # regardless of initializer shape (_fh = None, _warned = False, ...).
    rebound: dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Global):
                    for name in sub.names:
                        rebound.setdefault(name, node.lineno)
    for name in rebound:
        if name in model.locks or name in model.global_candidates:
            continue
        # Defining line: the module-level assignment if there is one
        # (plain or annotated — `_x: str | None = None` counts too).
        lineno = None
        for stmt in tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, ast.AnnAssign):
                targets = [stmt.target]
            if any(isinstance(t, ast.Name) and t.id == name
                   for t in targets):
                lineno = stmt.lineno
                break
        # Anchor: the module-level assignment when there is one; else the
        # rebinding function's def line — purely lazy-init globals with no
        # module-level spelling are still shared state and must not
        # escape the catalog.
        model.global_candidates[name] = (
            lineno if lineno is not None else rebound[name])

    # Classes: locks + concurrency + attribute writers.
    for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
        locks: set[str] = set()
        is_thread = any("Thread" in (dotted_name(b) or "") for b in cls.bases)
        init = next((m for m in cls.body if isinstance(m, ast.FunctionDef)
                     and m.name == "__init__"), None)
        if init is not None:
            for stmt in ast.walk(init):
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    tgts = (stmt.targets if isinstance(stmt, ast.Assign)
                            else [stmt.target])
                    value = stmt.value
                    for t in tgts:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            factory = _factory_of(value) if value else None
                            if factory in LOCK_FACTORIES:
                                locks.add(t.attr)
                            else:
                                # Every __init__-assigned attr gets a
                                # defining line — the anchor annotations
                                # and findings attach to.
                                model.attr_candidates.setdefault(
                                    (cls.name, t.attr), stmt.lineno)
        model.class_locks[cls.name] = locks
        if locks or is_thread:
            model.concurrent_classes.add(cls.name)
            for method in [m for m in cls.body
                           if isinstance(m, ast.FunctionDef)
                           and m.name != "__init__"]:
                for (attr, _node) in _self_attr_mutations(method):
                    model.attr_writers.setdefault(
                        (cls.name, attr), set()).add(method.name)
    return model


def _self_attr_mutations(fn: ast.FunctionDef):
    """(attr, node) for every mutation of ``self.<attr>`` in ``fn``:
    rebinds, augmented assigns, subscript stores/deletes, and mutator
    method calls."""

    def self_attr(node: ast.AST) -> str | None:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                attr = self_attr(t)
                if attr:
                    yield attr, node
                if isinstance(t, ast.Subscript):
                    attr = self_attr(t.value)
                    if attr:
                        yield attr, node
        elif isinstance(node, ast.AugAssign):
            attr = self_attr(node.target)
            if attr:
                yield attr, node
            if isinstance(node.target, ast.Subscript):
                attr = self_attr(node.target.value)
                if attr:
                    yield attr, node
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    attr = self_attr(t.value)
                    if attr:
                        yield attr, node
        elif isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in MUTATOR_METHODS):
                attr = self_attr(node.func.value)
                if attr:
                    yield attr, node


def _global_mutations(tree: ast.Module, name: str):
    """(node, fn) for every mutation of module-global ``name`` from inside
    a function: rebinds under a ``global`` declaration, subscript stores,
    aug-assigns, and mutator method calls."""
    for fn in [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]:
        declares_global = any(
            name in sub.names for sub in ast.walk(fn)
            if isinstance(sub, ast.Global))
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Name) and t.id == name
                            and declares_global):
                        yield node, fn
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == name):
                        yield node, fn
            elif isinstance(node, ast.AugAssign):
                t = node.target
                if isinstance(t, ast.Name) and t.id == name and declares_global:
                    yield node, fn
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == name):
                    yield node, fn
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == name):
                        yield node, fn
            elif isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in MUTATOR_METHODS
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == name):
                    yield node, fn


# --- lock-context resolution ---


def _lock_of_with_item(item: ast.withitem, model: ModuleModel,
                       cls: str | None) -> str | None:
    """Fully-qualified lock id for a with-item, or None if it is not a
    recognized lock: '<mod>.<name>' for module locks,
    '<mod>.<Class>.<attr>' for self locks, cross-module via import alias."""
    expr = item.context_expr
    if isinstance(expr, ast.Name):
        if expr.id in model.locks:
            return f"{model.modname}.{expr.id}"
        return None
    if isinstance(expr, ast.Attribute):
        if (isinstance(expr.value, ast.Name) and expr.value.id == "self"
                and cls is not None
                and expr.attr in model.class_locks.get(cls, ())):
            return f"{model.modname}.{cls}.{expr.attr}"
    return None


#: Scopes whose bodies run LATER, on whoever calls them — not under locks
#: held at the definition site (the Timer-callback false negative).
_DEFERRED_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _enclosing_locks(node: ast.AST, fn: ast.FunctionDef, model: ModuleModel,
                     cls: str | None) -> set[str]:
    """Locks actually held when ``node`` RUNS within ``fn``.  Walks real
    AST ancestry, not line spans: a with-item's context expression runs
    before acquisition, and a nested def/lambda body runs later on
    whatever thread invokes it — a lexical ``with lock:`` wrapped around
    a deferred body guards the *definition*, never the execution, so the
    ascent stops collecting at the first deferred-scope boundary (locks
    taken inside the nested body itself still count)."""
    parents: dict[ast.AST, ast.AST] = {}
    for sub in ast.walk(fn):
        for child in ast.iter_child_nodes(sub):
            parents[child] = sub
    held: set[str] = set()
    cur: ast.AST = node
    while cur is not fn:
        par = parents.get(cur)
        if par is None:
            break
        if isinstance(par, _DEFERRED_SCOPES) and par is not fn:
            break
        if isinstance(par, (ast.With, ast.AsyncWith)) and cur in par.body:
            for item in par.items:
                lock = _lock_of_with_item(item, model, cls)
                if lock:
                    held.add(lock)
        cur = par
    return held


def _short_lock(lock_id: str, model: ModuleModel, cls: str | None) -> str:
    """Render a lock id the way the annotation grammar wants it written at
    a use site in (model, cls): 'self._lock' or '_lock'."""
    parts = lock_id.split(".")
    if cls is not None and lock_id == f"{model.modname}.{cls}.{parts[-1]}":
        return f"self.{parts[-1]}"
    if lock_id == f"{model.modname}.{parts[-1]}":
        return parts[-1]
    return lock_id


def _resolve_annotation_lock(arg: str, model: ModuleModel,
                             cls: str | None) -> str | None:
    """The fully-qualified lock id an annotation argument names, or None
    (including the 'none: reason' escape, which returns the sentinel
    'none')."""
    arg = arg.strip()
    # The lock-free escape is exactly 'none: <reason>' — a prefix match
    # would let a typo'd lock name starting with 'none' silently disable
    # checking, and bare 'none' without a reason documents nothing.
    if arg.startswith("none:") and arg[5:].strip():
        return "none"
    name = arg[5:] if arg.startswith("self.") else arg
    if arg.startswith("self.") and cls is not None:
        if name in model.class_locks.get(cls, ()):
            return f"{model.modname}.{cls}.{name}"
        return None
    if name in model.locks:
        return f"{model.modname}.{name}"
    return None


# --- ICT007: guarded-by discipline ---


def check_guarded_by(models: list[ModuleModel]) -> list[Finding]:
    out: list[Finding] = []
    for model in models:
        sf = model.sf
        tree = sf.tree
        # Module globals.
        for name, lineno in sorted(model.global_candidates.items()):
            ann = sf.annotation(lineno, "guarded-by")
            mutations = list(_global_mutations(tree, name))
            if not mutations and ann is None:
                # A mutable literal nobody ever writes from a function
                # (__all__, a module-constant table) has nothing to guard.
                continue
            if ann is None:
                fix = _consistent_lock_fix(
                    mutations, model, None)
                out.append(sf.finding(
                    "ICT007/guarded-by", lineno,
                    f"module-global mutable state '{name}' (written from "
                    f"{len(mutations)} site(s)) has no "
                    f"'# ict: guarded-by(<lock>)' annotation",
                    fix_append=fix))
                continue
            lock = _resolve_annotation_lock(ann, model, None)
            if lock is None:
                out.append(sf.finding(
                    "ICT007/guarded-by", lineno,
                    f"'{name}' names unknown lock {ann!r} in its "
                    f"guarded-by annotation (declare the lock at module "
                    f"level or use 'none: <reason>')"))
                continue
            if lock == "none":
                continue
            for node, fn in mutations:
                held = _enclosing_locks(node, fn, model, None)
                if lock not in held:
                    out.append(sf.finding(
                        "ICT007/guarded-by", node.lineno,
                        f"write to '{name}' in {fn.name}() outside its "
                        f"declared lock "
                        f"'{_short_lock(lock, model, None)}'"))
        # Concurrent-class attributes.
        for cls in sorted(model.concurrent_classes):
            cls_node = next(n for n in tree.body
                            if isinstance(n, ast.ClassDef) and n.name == cls)
            methods = {m.name: m for m in cls_node.body
                       if isinstance(m, ast.FunctionDef)}
            for (owner, attr), writers in sorted(model.attr_writers.items()):
                if owner != cls:
                    continue
                mutations = [
                    (node, methods[m]) for m in sorted(writers)
                    for a, node in _self_attr_mutations(methods[m])
                    if a == attr]
                # Anchor: the __init__ assignment when there is one, else
                # the first mutation site (lazy-init attrs must not
                # escape the rule just because __init__ never names them).
                def_line = model.attr_candidates.get((cls, attr))
                anchor = def_line or min(n.lineno for n, _ in mutations)
                ann = sf.annotation(anchor, "guarded-by")
                if ann is None:
                    if len(writers) < 2:
                        continue  # single post-init writer: out of scope
                    fix = _consistent_lock_fix(mutations, model, cls)
                    where = ("its __init__ assignment" if def_line
                             else "its first write (no __init__ assignment)")
                    out.append(sf.finding(
                        "ICT007/guarded-by", anchor,
                        f"'{cls}.{attr}' is mutated from "
                        f"{len(writers)} methods "
                        f"({', '.join(sorted(writers))}) with no "
                        f"'# ict: guarded-by(<lock>)' annotation on "
                        f"{where}",
                        fix_append=fix))
                    continue
                lock = _resolve_annotation_lock(ann, model, cls)
                if lock is None:
                    out.append(sf.finding(
                        "ICT007/guarded-by", anchor,
                        f"'{cls}.{attr}' names unknown lock {ann!r} in "
                        f"its guarded-by annotation"))
                    continue
                if lock == "none":
                    continue
                for m in sorted(writers):
                    for a, node in _self_attr_mutations(methods[m]):
                        if a != attr:
                            continue
                        held = _enclosing_locks(node, methods[m], model, cls)
                        if lock not in held:
                            out.append(sf.finding(
                                "ICT007/guarded-by", node.lineno,
                                f"write to 'self.{attr}' in "
                                f"{cls}.{m}() outside its declared lock "
                                f"'{_short_lock(lock, model, cls)}'"))
    return out


def _consistent_lock_fix(mutations, model: ModuleModel,
                         cls: str | None) -> str | None:
    """When every mutation already runs under one common lock, the
    annotation is mechanical: --fix appends it."""
    if not mutations:
        return None
    commons: set[str] | None = None
    for node, fn in mutations:
        held = _enclosing_locks(node, fn, model, cls)
        commons = held if commons is None else (commons & held)
        if not commons:
            return None
    lock = sorted(commons)[0]
    return f"# ict: guarded-by({_short_lock(lock, model, cls)})"


# --- ICT008: lock-order inversions ---


def check_lock_order(models: list[ModuleModel]) -> list[Finding]:
    """Edges A->B when B is acquired while A is held — lexically, or via a
    call resolvable inside the analyzed set (same module, same class, or
    an imported analyzed module).  A cycle is reported once, at one of its
    acquisition sites."""
    # fn id: (modname, qualname) -> {"locks": set, "calls": set[fn id]}
    fn_map: dict[tuple[str, str], dict] = {}
    mod_by_name = {m.modname: m for m in models}
    alias_to_mod: dict[tuple[str, str], str] = {}
    for model in models:
        for alias, target in model.import_aliases.items():
            # "iterative_cleaner_tpu_torch.obs.tracing" / "obs.tracing" endings.
            for other in models:
                if target.endswith(other.modname):
                    alias_to_mod[(model.modname, alias)] = other.modname

    def record_fn(model: ModuleModel, fn: ast.FunctionDef, cls: str | None):
        qual = f"{cls}.{fn.name}" if cls else fn.name
        info = {"locks": set(), "calls": set()}
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = _lock_of_with_item(item, model, cls)
                    if lock:
                        info["locks"].add(lock)
            elif isinstance(node, ast.Call):
                callee = _resolve_call(node, model, cls)
                if callee:
                    info["calls"].add(callee)
        fn_map[(model.modname, qual)] = info

    def _resolve_call(node: ast.Call, model: ModuleModel,
                      cls: str | None) -> tuple[str, str] | None:
        func = node.func
        if isinstance(func, ast.Name):
            return (model.modname, func.id)
        if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            base = func.value.id
            if base == "self" and cls is not None:
                return (model.modname, f"{cls}.{func.attr}")
            target_mod = alias_to_mod.get((model.modname, base))
            if target_mod:
                return (target_mod, func.attr)
        return None

    for model in models:
        tree = model.sf.tree
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                record_fn(model, node, None)
            elif isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, ast.FunctionDef):
                        record_fn(model, m, node.name)

    # Transitive lock sets per function (may-acquire).
    acq_memo: dict[tuple[str, str], set[str]] = {}

    def may_acquire(fid: tuple[str, str], stack: frozenset) -> set[str]:
        if fid in acq_memo:
            return acq_memo[fid]
        if fid not in fn_map or fid in stack:
            return set()
        info = fn_map[fid]
        locks = set(info["locks"])
        for callee in info["calls"]:
            locks |= may_acquire(callee, stack | {fid})
        if not stack:
            # Memoize ROOT results only: a result computed mid-recursion
            # may be truncated by the cycle guard above (a recursive call
            # back into the stack contributes set()), and caching that
            # partial set would permanently hide lock edges through the
            # cycle — the detector's whole purpose.
            acq_memo[fid] = locks
        return locks

    # Edges with one example site each.
    edges: dict[tuple[str, str], tuple[str, int, str]] = {}

    def add_edge(a: str, b: str, model: ModuleModel, lineno: int, why: str):
        if a != b:
            edges.setdefault((a, b), (model.sf.path, lineno, why))

    for model in models:
        tree = model.sf.tree
        scopes: list[tuple[ast.FunctionDef, str | None]] = []
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                scopes.append((node, None))
            elif isinstance(node, ast.ClassDef):
                scopes.extend((m, node.name) for m in node.body
                              if isinstance(m, ast.FunctionDef))
        for fn, cls in scopes:
            for node in ast.walk(fn):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    held = [
                        lock for item in node.items
                        for lock in [_lock_of_with_item(item, model, cls)]
                        if lock]
                    if not held:
                        continue
                    for sub in ast.walk(node):
                        if sub is node:
                            continue
                        if isinstance(sub, (ast.With, ast.AsyncWith)):
                            for item in sub.items:
                                inner = _lock_of_with_item(item, model, cls)
                                if inner:
                                    for a in held:
                                        add_edge(a, inner, model, sub.lineno,
                                                 "nested with")
                        elif isinstance(sub, ast.Call):
                            callee = _resolve_call(sub, model, cls)
                            if callee:
                                for b in may_acquire(callee, frozenset()):
                                    for a in held:
                                        add_edge(
                                            a, b, model, sub.lineno,
                                            f"call to "
                                            f"{callee[0]}.{callee[1]}()")

    # Cycle detection over the edge graph.
    graph: dict[str, set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    out: list[Finding] = []
    reported: set[frozenset] = set()

    def dfs(start: str, node: str, path: list[str], seen: set[str]):
        for nxt in sorted(graph.get(node, ())):
            if nxt == start and len(path) >= 1:
                cyc = frozenset(path + [start])
                if cyc in reported:
                    continue
                reported.add(cyc)
                cycle = path + [start, start]
                edge = edges[(path[-1], start)] if (path[-1], start) in edges \
                    else edges[(start, path[0])]
                src, lineno, why = edge
                sf = next(m.sf for m in models if m.sf.path == src)
                out.append(sf.finding(
                    "ICT008/lock-order", lineno,
                    "lock-order inversion: "
                    + " -> ".join(path + [start, path[0]])
                    + f" (edge here: {why}); threads taking these locks "
                    "in different orders can deadlock"))
            elif nxt not in seen:
                dfs(start, nxt, path + [nxt], seen | {nxt})

    for node in sorted(graph):
        dfs(node, node, [node], {node})
    return out


def run_race_rules(files: list[SourceFile]) -> list[Finding]:
    in_scope = [sf for sf in files
                if sf.path.startswith(RACE_SCOPE_PREFIXES)
                and not sf.parse_error]
    models = [build_model(sf) for sf in in_scope]
    return check_guarded_by(models) + check_lock_order(models)
