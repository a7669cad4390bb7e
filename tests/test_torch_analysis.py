"""The port's static analysis suite (iterative_cleaner_tpu_torch/analysis,
tools_torch/ict_lint.py): per-rule fixture snippets (a seeded violation and
its clean twin, in torch's spellings), the parity of the shared rules with
the JAX package's on the same fixtures, the port's tree clean, and the torch
route contracts on the CPU with seeded host reads, uploads and float64.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu_torch.analysis import contracts
from iterative_cleaner_tpu_torch.analysis.engine import (
    Finding,
    collect_project_files,
    load_baseline,
    load_source_file,
    malformed_annotations,
    split_baselined,
    write_baseline,
)
from iterative_cleaner_tpu_torch.analysis.races import run_race_rules
from iterative_cleaner_tpu_torch.analysis.rules import (
    rule_device_init,
    rule_mask_f64,
    rule_mask_nondet,
    rule_metric_grammar,
    rule_metric_registration,
    run_source_rules,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "iterative_cleaner_tpu_torch"
LINT = os.path.join(REPO_ROOT, "tools_torch", "ict_lint.py")


def _sf(tmp_path, source: str, relname: str = "fixture.py"):
    """Write a snippet and load it as a SourceFile under a repo-shaped
    relative path (rules key off path prefixes)."""
    path = tmp_path / relname
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return load_source_file(str(tmp_path), relname)


def _rules_of(findings: list[Finding]) -> set[str]:
    return {f.rule for f in findings}


# --- engine ---


class TestEngine:
    def test_annotation_parsing_and_placement(self, tmp_path):
        sf = _sf(tmp_path, """\
            # ict: guarded-by(_lock)
            x = {}
            y = {}  # ict: guarded-by(_lock)
            z = {}
        """)
        assert sf.annotation(2, "guarded-by") == "_lock"
        assert sf.annotation(3, "guarded-by") == "_lock"
        assert sf.annotation(4, "guarded-by") is None

    def test_malformed_annotation_is_a_finding(self, tmp_path):
        sf = _sf(tmp_path, "x = {}  # ict: guarded-by()\n")
        findings = malformed_annotations(sf)
        assert len(findings) == 1 and "non-empty" in findings[0].message
        ok = _sf(tmp_path, "x = {}  # ict: guarded-by(none: read-only table)\n", "g.py")
        assert malformed_annotations(ok) == []
        made_up = _sf(tmp_path, "x = {}  # ict: made-up-kind(reason)\n", "f2.py")
        assert len(malformed_annotations(made_up)) == 1

    def test_fingerprint_stable_across_line_moves(self, tmp_path):
        sf_a = _sf(tmp_path, "import torch\nbad = torch.cuda.synchronize\n")
        sf_b = _sf(tmp_path, "import torch\n\n\nbad = torch.cuda.synchronize\n", "g.py")
        f_a, f_b = sf_a.finding("R", 2, "m"), sf_b.finding("R", 4, "m")
        f_b.path = f_a.path
        assert f_a.fingerprint == f_b.fingerprint

    def test_baseline_roundtrip_suppresses(self, tmp_path):
        finding = _sf(tmp_path, "x = 1\n").finding("R/x", 1, "msg")
        path = tmp_path / "baseline.json"
        write_baseline(str(path), [finding])
        fresh, suppressed = split_baselined([finding], load_baseline(str(path)))
        assert fresh == [] and suppressed == [finding]

    def test_project_files_are_the_ports(self):
        files = collect_project_files(REPO_ROOT)
        assert "chip_smoke.py" in files and "tools_torch/ict_lint.py" in files
        assert f"{PKG}/analysis/contracts.py" in files
        assert all(f.startswith((f"{PKG}/", "tools_torch/")) or f == "chip_smoke.py"
                   for f in files)
        assert not any("/_build/" in f or f.startswith("iterative_cleaner_tpu/")
                       for f in files)


# --- ICT001 device-init, torch's spellings ---


class TestDeviceInit:
    @pytest.mark.parametrize("src", [
        "import torch\n\ndef f():\n    torch.cuda.synchronize()\n",
        "import torch\n\ndef f():\n    return torch.cuda.current_stream()\n",
        "import torch\n\ndef f(d):\n    return torch.cuda.mem_get_info(d)\n",
        "from torch import cuda\n\ndef f():\n    return cuda.device_count()\n",
        "from torch.cuda import init as i\n\ndef f():\n    i()\n",
        "import torch\n\ndef f(t):\n    with torch.cuda.device(t.device):\n        pass\n",
    ])
    def test_positive(self, tmp_path, src):
        sf = _sf(tmp_path, src, f"{PKG}/service/x.py")
        findings = rule_device_init(sf)
        assert _rules_of(findings) == {"ICT001/device-init"} and findings[0].line == 4

    def test_watchdog_guard_negative(self, tmp_path):
        sf = _sf(tmp_path, """\
            import torch
            from iterative_cleaner_tpu_torch.utils.device_probe import init_watchdog

            def f():
                with init_watchdog("x"):
                    torch.cuda.init()
        """, f"{PKG}/service/x.py")
        assert rule_device_init(sf) == []

    def test_annotation_negative(self, tmp_path):
        sf = _sf(tmp_path, """\
            import torch

            def f():
                torch.cuda.synchronize()  # ict: backend-init-ok(operands on the card)
        """, f"{PKG}/service/x.py")
        assert rule_device_init(sf) == []

    def test_uncounted_calls_negative(self, tmp_path):
        """is_available, is_initialized, the allocator's statistics and
        empty_cache create no context (the module says why)."""
        sf = _sf(tmp_path, """\
            import torch

            def f():
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.empty_cache()
                    return torch.cuda.max_memory_allocated()
        """, f"{PKG}/service/x.py")
        assert rule_device_init(sf) == []

    def test_device_probe_module_exempt(self, tmp_path):
        sf = _sf(tmp_path, "import torch\n\ndef f():\n    torch.cuda.init()\n",
                 f"{PKG}/utils/device_probe.py")
        assert rule_device_init(sf) == []


# --- ICT002 / ICT003 mask-module hygiene ---


class TestMaskRules:
    @pytest.mark.parametrize("line", [
        "DT = np.float64", "DT = torch.float64", "DT = torch.double",
        "DT = torch.cdouble", "DT = torch.complex128", "y = x.double()",
        'y = x.astype("float64")', 'y = torch.zeros(3, dtype="complex128")',
    ])
    def test_f64_positive_and_annotated(self, tmp_path, line):
        src = f"import numpy as np\nimport torch\nx = torch.zeros(2)\n{line}\n"
        bad = _sf(tmp_path, src, f"{PKG}/ops/x.py")
        findings = rule_mask_f64(bad)
        assert _rules_of(findings) == {"ICT002/mask-f64"} and findings[0].line == 4
        ok = _sf(tmp_path, src.replace(line, line + "  # ict: f64-ok(--x64 opt-in)"),
                 f"{PKG}/ops/y.py")
        assert rule_mask_f64(ok) == []

    def test_f64_in_both_backends_and_finalize(self, tmp_path):
        for rel in ("backends/torch_backend.py", "backends/numpy_backend.py",
                    "online/finalize.py", "core/x.py", "parallel/x.py"):
            sf = _sf(tmp_path, "import torch\nDT = torch.double\n", f"{PKG}/{rel}")
            assert _rules_of(rule_mask_f64(sf)) == {"ICT002/mask-f64"}, rel

    def test_f64_outside_mask_modules_ignored(self, tmp_path):
        sf = _sf(tmp_path, "import torch\nDT = torch.double\n", f"{PKG}/obs/x.py")
        assert rule_mask_f64(sf) == []

    @pytest.mark.parametrize("call", [
        "time.time()", "random.random()", "torch.randn(4)", "torch.rand(2, 3)",
        "torch.randint(0, 9, (3,))", "torch.randperm(5)", "torch.normal(x, 1.0)",
        "torch.bernoulli(x)", "torch.multinomial(x, 1)", "torch.random.manual_seed(1)",
        "x.index_add_(0, i, x)", "torch.index_add(x, 0, i, x)", "x.scatter_add_(0, i, x)",
        "x.index_put_((i,), x, accumulate=True)",
    ])
    def test_nondet_positive_and_annotated(self, tmp_path, call):
        src = (f"import random, time\nimport torch\n\ndef f(x, i):\n    return {call}\n")
        bad = _sf(tmp_path, src, f"{PKG}/core/x.py")
        findings = rule_mask_nondet(bad)
        assert _rules_of(findings) == {"ICT003/mask-nondet"} and findings[0].line == 5
        ok = _sf(tmp_path, src.replace(call, call + "  # ict: nondet-ok(not on a mask)"),
                 f"{PKG}/core/y.py")
        assert rule_mask_nondet(ok) == []

    @pytest.mark.parametrize("call", [
        "torch.randn(4, generator=g)", "torch.randperm(5, generator=g)",
        "x.index_put_((i,), x)", "x.index_put_((i,), x, accumulate=False)",
        "x.index_select(0, i)", "time.perf_counter()",
    ])
    def test_nondet_clean_twins(self, tmp_path, call):
        src = (f"import time\nimport torch\n\ndef f(x, i, g):\n    return {call}\n")
        assert rule_mask_nondet(_sf(tmp_path, src, f"{PKG}/ops/x.py")) == []

    def test_nondet_import_style_evasion_caught(self, tmp_path):
        sf = _sf(tmp_path, """\
            from time import time
            from torch import randn as rn
            import numpy.random as npr

            def f():
                return time() + npr.normal() + rn(3)
        """, f"{PKG}/core/w.py")
        assert len(rule_mask_nondet(sf)) == 3

    def test_no_mask_module_scatters_today(self):
        files = [load_source_file(REPO_ROOT, rel) for rel in collect_project_files(REPO_ROOT)]
        assert [f.render() for sf in files for f in rule_mask_nondet(sf)] == []


# --- ICT005 metric grammar / registration ---


class TestMetricRules:
    def test_grammar_positive(self, tmp_path):
        sf = _sf(tmp_path, """\
            from iterative_cleaner_tpu_torch.obs import tracing

            tracing.count("Bad-Name")
            tracing.count_labeled("fine_name", {"Bad-Key": "v"})
            tracing.count("fine_name_total")
        """)
        assert [f.line for f in rule_metric_grammar(sf)] == [3, 4]

    def test_registration_conflict(self, tmp_path):
        sf = _sf(tmp_path, """\
            from iterative_cleaner_tpu_torch.obs import tracing

            tracing.count("my_family")
            tracing.set_gauge("my_family", 1.0)
            tracing.count_labeled("fam2", {"route": "a"})
            tracing.count_labeled("fam2", {"shape": "b"})
            tracing.count_labeled("fam3", {"route": "a"})
            tracing.count_labeled("fam3", {"route": "b"})
        """)
        findings = rule_metric_registration([sf])
        msgs = " | ".join(f.message for f in findings)
        assert len(findings) == 2 and "one family, one kind" in msgs and "label keys" in msgs


# --- ICT007 guarded-by / ICT008 lock order ---


class TestGuardedBy:
    def test_unannotated_global_flagged_with_fix(self, tmp_path):
        sf = _sf(tmp_path, """\
            import threading

            _lock = threading.Lock()
            _registry = {}

            def add(k, v):
                with _lock:
                    _registry[k] = v
        """, f"{PKG}/obs/fixture.py")
        findings = run_race_rules([sf])
        assert _rules_of(findings) == {"ICT007/guarded-by"}
        assert findings[0].fix_append == "# ict: guarded-by(_lock)"

    def test_write_outside_declared_lock(self, tmp_path):
        sf = _sf(tmp_path, """\
            import threading

            _lock = threading.Lock()
            _registry = {}  # ict: guarded-by(_lock)

            def add(k, v):
                _registry[k] = v
        """, f"{PKG}/obs/fixture.py")
        findings = run_race_rules([sf])
        assert len(findings) == 1 and "outside its declared lock" in findings[0].message

    def test_write_in_a_helper_the_caller_locks_is_outside(self, tmp_path):
        """The profiler's fault: a helper writes state its caller's lock
        guards; the rule is lexical, so the write must sit under the
        ``with`` itself."""
        sf = _sf(tmp_path, """\
            import threading

            _lock = threading.Lock()
            _active = None  # ict: guarded-by(_lock)

            def _claim(x):
                global _active
                _active = x

            def start(x):
                with _lock:
                    _claim(x)
        """, f"{PKG}/obs/fixture.py")
        findings = run_race_rules([sf])
        assert len(findings) == 1 and findings[0].line == 8

    def test_annotated_and_guarded_is_clean(self, tmp_path):
        sf = _sf(tmp_path, """\
            import threading

            _lock = threading.Lock()
            _registry = {}  # ict: guarded-by(_lock)

            def add(k, v):
                with _lock:
                    _registry[k] = v
        """, f"{PKG}/obs/fixture.py")
        assert run_race_rules([sf]) == []

    @pytest.mark.parametrize("rel", [
        "backends/torch_backend.py", "ops/fused_kernels.py", "ops/template.py",
        "ops/cuda_build.py", "native.py", "ingest/codec.py", "ingest/pipeline.py",
        "utils/device_probe.py", "service/x.py", "fleet/x.py", "campaign/x.py",
        "proving/x.py",
    ])
    def test_scope_covers_the_shared_modules(self, tmp_path, rel):
        sf = _sf(tmp_path, "_cache = {}\n\ndef put(k):\n    _cache[k] = 1\n", f"{PKG}/{rel}")
        assert _rules_of(run_race_rules([sf])) == {"ICT007/guarded-by"}

    def test_out_of_scope_module_ignored(self, tmp_path):
        sf = _sf(tmp_path, "_cache = {}\n\ndef put(k):\n    _cache[k] = 1\n",
                 f"{PKG}/ops/stats.py")
        assert run_race_rules([sf]) == []

    def test_none_escape_and_unknown_lock(self, tmp_path):
        ok = _sf(tmp_path, "_c = {}  # ict: guarded-by(none: idempotent memo)\n\n"
                 "def n(k):\n    _c[k] = 1\n", f"{PKG}/obs/a.py")
        assert run_race_rules([ok]) == []
        bad = _sf(tmp_path, "_c = {}  # ict: guarded-by(nonexistent_lock)\n\n"
                  "def n(k):\n    _c[k] = 1\n", f"{PKG}/obs/b.py")
        findings = run_race_rules([bad])
        assert len(findings) == 1 and "unknown lock" in findings[0].message

    def test_multiwriter_class_attr_flagged(self, tmp_path):
        sf = _sf(tmp_path, """\
            import threading

            class Svc:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.mode = "a"

                def demote(self):
                    self.mode = "b"

                def restore(self):
                    self.mode = "a"
        """, f"{PKG}/service/fixture.py")
        findings = run_race_rules([sf])
        assert len(findings) == 1 and "Svc.mode" in findings[0].message


class TestLockOrder:
    def _run(self, sf):
        return [f for f in run_race_rules([sf]) if f.rule == "ICT008/lock-order"]

    def test_seeded_inversion_caught(self, tmp_path):
        sf = _sf(tmp_path, """\
            import threading

            _lock_a = threading.Lock()
            _lock_b = threading.Lock()

            def forward():
                with _lock_a:
                    with _lock_b:
                        pass

            def backward():
                with _lock_b:
                    with _lock_a:
                        pass
        """, f"{PKG}/ops/template.py")
        findings = self._run(sf)
        assert findings and "lock-order inversion" in findings[0].message

    def test_inversion_via_call_chain_caught(self, tmp_path):
        sf = _sf(tmp_path, """\
            import threading

            _lock_a = threading.Lock()
            _lock_b = threading.Lock()

            def take_a():
                with _lock_a:
                    pass

            def forward():
                with _lock_a:
                    with _lock_b:
                        pass

            def backward():
                with _lock_b:
                    take_a()
        """, f"{PKG}/service/fixture.py")
        assert self._run(sf)

    def test_consistent_order_clean(self, tmp_path):
        sf = _sf(tmp_path, """\
            import threading

            _lock_a = threading.Lock()
            _lock_b = threading.Lock()

            def one():
                with _lock_a:
                    with _lock_b:
                        pass

            def two():
                with _lock_a:
                    with _lock_b:
                        pass
        """, f"{PKG}/service/fixture.py")
        assert self._run(sf) == []


# --- parity with the JAX package's rules on shared fixtures ---


#: (fixture, path inside the package, source): every rule both packages
#: share, each seeded, in spellings both packages know.
PARITY_FIXTURES = [
    ("annotation-grammar", "ops/x.py", "x = {}  # ict: guarded-by()\ny = 1  # ict: nope(why)\n"),
    ("f64", "ops/x.py", """\
        import numpy as np

        def f(x):
            a = x.astype("float64")
            b = np.empty(3, dtype="complex128")
            return a, b, np.float64, np.complex128  # ict: f64-ok(parity twin)
        DT = np.float64
    """),
    ("nondet", "core/x.py", """\
        import time, random
        from time import time as now
        import numpy.random as npr

        def f():
            return time.time() + random.random() + now() + npr.normal() + time.perf_counter()
        def g():
            return time.time()  # ict: nondet-ok(telemetry timestamp only)
    """),
    ("metric", "obs/x.py", """\
        from x.obs import tracing

        tracing.count("Bad-Name")
        tracing.count_labeled("fine_name", {"Bad-Key": "v"})
        tracing.count("my_family")
        tracing.set_gauge("my_family", 1.0)
        tracing.count_labeled("fam2", {"route": "a"})
        tracing.count_labeled("fam2", {"shape": "b"})
    """),
    ("guarded-by", "obs/fixture.py", """\
        import threading

        _lock = threading.Lock()
        _registry = {}
        _guarded = {}  # ict: guarded-by(_lock)
        _path: str | None = None

        def add(k, v):
            with _lock:
                _registry[k] = v
            _guarded[k] = v

        def schedule():
            with _lock:
                threading.Timer(5, lambda: _guarded.clear()).start()

        def set_a(p):
            global _path
            _path = p

        def lazy():
            global _cache
            _cache = {}
    """),
    ("class-attrs", "service/fixture.py", """\
        import threading

        class Svc:
            def __init__(self):
                self._lock = threading.Lock()
                self.mode = "a"
                self.port = 0

            def demote(self):
                self.mode = "b"

            def restore(self):
                self.mode = "a"
                self.port = 1

            def open(self):
                self._late = {}

            def close(self):
                self._late = None
    """),
    ("lock-order", "service/fixture.py", """\
        import threading

        _lock_a = threading.Lock()
        _lock_b = threading.Lock()

        def rec_a():
            with _lock_a:
                pass
            rec_b()

        def rec_b():
            with _lock_b:
                pass
            rec_a()

        def forward():
            with _lock_a:
                with _lock_b:
                    pass

        def backward():
            with _lock_b:
                rec_a()
    """),
]

SHARED_RULES = ("ICT000", "ICT002", "ICT003", "ICT005", "ICT007", "ICT008")


@pytest.mark.parametrize("name,rel,src", PARITY_FIXTURES, ids=[f[0] for f in PARITY_FIXTURES])
def test_shared_rules_match_the_jax_package(tmp_path, name, rel, src):
    """The same fixture under each package's prefix gives the same rule ids,
    lines and mechanical fixes through the JAX rules and the port's."""
    from iterative_cleaner_tpu.analysis import engine as jax_engine
    from iterative_cleaner_tpu.analysis.races import run_race_rules as jax_races
    from iterative_cleaner_tpu.analysis.rules import run_source_rules as jax_source

    def shared(findings):
        return sorted((f.rule, f.line, f.fix_append or "") for f in findings
                      if f.rule.startswith(SHARED_RULES))

    jax_rel, port_rel = f"iterative_cleaner_tpu/{rel}", f"{PKG}/{rel}"
    for r in (jax_rel, port_rel):
        (tmp_path / r).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / r).write_text(textwrap.dedent(src))
    jax_sf = jax_engine.load_source_file(str(tmp_path), jax_rel)
    port_sf = load_source_file(str(tmp_path), port_rel)
    got_jax = shared(jax_source([jax_sf]) + jax_races([jax_sf]))
    got_port = shared(run_source_rules([port_sf]) + run_race_rules([port_sf]))
    assert got_jax, f"fixture {name} seeds no shared finding"
    assert got_port == got_jax


# --- the tree itself is clean (the gate, in-process and through the CLI) ---


class TestTreeClean:
    def test_source_and_race_layers_clean_on_tree(self):
        files = [load_source_file(REPO_ROOT, rel) for rel in collect_project_files(REPO_ROOT)]
        findings = run_source_rules(files) + run_race_rules(files)
        baseline = load_baseline(os.path.join(REPO_ROOT, "tools_torch", "ict_lint_baseline.json"))
        fresh, _ = split_baselined(findings, baseline)
        assert fresh == [], "\n" + "\n".join(f.render() for f in fresh)

    def test_baseline_entries_all_have_notes(self):
        with open(os.path.join(REPO_ROOT, "tools_torch", "ict_lint_baseline.json")) as fh:
            data = json.load(fh)
        for entry in data.get("findings", []):
            assert entry.get("note"), f"baseline entry without a note: {entry}"

    def test_cli_exit_codes(self, tmp_path):
        proc = subprocess.run([sys.executable, LINT, "--source", "--races", "-q"],
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        bad = tmp_path / "bad_fixture.py"
        bad.write_text("import torch\n\ndef f():\n    torch.cuda.synchronize()\n")
        proc = subprocess.run([sys.executable, LINT, "--source", str(bad), "-q"],
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 1 and "ICT001/device-init" in proc.stdout

    def test_cli_contracts_need_the_card_unless_asked(self):
        proc = subprocess.run([sys.executable, LINT, "--contracts", "-q"],
                              capture_output=True, text=True, timeout=120)
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device runs")
        assert proc.returncode == 2 and "--device cpu" in proc.stderr

    def test_cli_all_on_the_cpu_is_clean(self):
        proc = subprocess.run([sys.executable, LINT, "--all", "--device", "cpu"],
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "source+races+contracts" in proc.stderr

    def test_fix_appends_the_consistent_lock(self, tmp_path):
        from iterative_cleaner_tpu_torch.analysis.engine import apply_fixes

        sf = _sf(tmp_path, """\
            import threading

            _lock = threading.Lock()
            _registry = {}

            def add(k, v):
                with _lock:
                    _registry[k] = v
        """, f"{PKG}/obs/fixture.py")
        assert apply_fixes(str(tmp_path), run_race_rules([sf])) == 1
        again = load_source_file(str(tmp_path), f"{PKG}/obs/fixture.py")
        assert run_race_rules([again]) == []


# --- ICT009: the torch route contracts on the CPU ---


@pytest.fixture(scope="module")
def cpu_runs():
    return contracts.run_routes("cpu")


def _seed(monkeypatch, extra):
    """Make every step's scores pass through ``extra`` inside the route."""
    from iterative_cleaner_tpu_torch.backends import torch_backend as tb

    orig = tb.scale_and_combine

    def seeded(*args, **kwargs):
        return extra(orig(*args, **kwargs))

    monkeypatch.setattr(tb, "scale_and_combine", seeded)


class TestRouteContracts:
    def test_all_four_routes_pass(self):
        findings = contracts.check_routes("cpu")
        assert findings == [], "\n" + "\n".join(f.render() for f in findings)

    def test_route_coverage_is_total(self, cpu_runs):
        runs, failures = cpu_runs
        assert failures == []
        assert {(r.route, r.label) for r in runs} == {
            (route, label) for route, labels in contracts.ROUTE_HOST_READS.items()
            for label in labels}
        assert set(contracts.ROUTE_HOST_READS) == {"stepwise", "fused", "chunked", "batch"}
        assert {r.kernel for r in runs} == {False, True}

    def test_every_ledger_line_names_a_unit_and_a_reason(self):
        for labels in contracts.ROUTE_HOST_READS.values():
            for lines in labels.values():
                for line in lines:
                    assert line.kind in ("read", "upload") and line.count > 0
                    assert line.unit in contracts.UNITS and line.what

    def test_runs_exercise_the_sparse_update_and_both_directions(self, cpu_runs):
        runs, _ = cpu_runs
        by = {(r.route, r.label, r.kernel): r for r in runs}
        chunked = by[("chunked", "ChunkedTorchCleaner.step", True)]
        assert chunked.units["sparse update"] > 0 and chunked.units["dense pass"] > 0
        stepwise = by[("stepwise", "TorchCleaner.step", False)]
        assert stepwise.trace.reads and stepwise.trace.uploads
        assert by[("stepwise", "sparse_template_candidate", False)].trace.reads == []
        assert all(not r.trace.f64 for r in runs)

    def test_seeded_item_inside_a_route_is_caught(self, monkeypatch):
        _seed(monkeypatch, lambda t: (t.sum().item(), t)[1])
        runs, _ = contracts.run_routes("cpu", routes={"fused"})
        kinds = {f.snippet.rsplit(":", 1)[1] for r in runs for f in contracts.check_run(r)}
        assert kinds == {"reads"}

    def test_seeded_nonzero_inside_a_route_is_caught(self, monkeypatch):
        _seed(monkeypatch, lambda t: (torch.nonzero(t >= 1.0), t)[1])
        runs, _ = contracts.run_routes("cpu", routes={"batch"})
        findings = [f for r in runs for f in contracts.check_run(r)]
        assert findings and all(f.snippet.endswith(":reads") for f in findings)
        assert "more" not in findings[0].message and "does not count" in findings[0].message

    def test_seeded_double_inside_a_route_is_caught(self, monkeypatch):
        _seed(monkeypatch, lambda t: t.double().float())
        runs, _ = contracts.run_routes("cpu", routes={"fused"})
        findings = [f for r in runs for f in contracts.check_run(r)]
        assert findings and {f.snippet.rsplit(":", 1)[1] for f in findings} == {"dtype"}
        assert "float64" in findings[0].message

    def test_seeded_upload_inside_a_route_is_caught(self, monkeypatch):
        _seed(monkeypatch, lambda t: t + torch.from_numpy(np.zeros(1, np.float32)).to(t.device))
        runs, _ = contracts.run_routes("cpu", routes={"fused"})
        kinds = {f.snippet.rsplit(":", 1)[1] for r in runs for f in contracts.check_run(r)}
        assert kinds == {"uploads"}

    def test_a_vanished_read_is_caught(self, cpu_runs):
        runs, _ = cpu_runs
        run = next(r for r in runs if r.label == "incremental_template")
        stale = contracts.RouteRun(run.route, run.label, run.kernel, run.units, run.trace,
                                   {"read": 2, "upload": 0})
        [finding] = contracts.check_run(stale)
        assert "vanished" in finding.message

    def test_card_syncs_are_held_to_reads_plus_uploads(self, cpu_runs):
        runs, _ = cpu_runs
        run = next(r for r in runs if r.label == "TorchCleaner.step")
        trace = contracts.Trace("cpu")
        trace.reads, trace.uploads = list(run.trace.reads), list(run.trace.uploads)
        trace.syncs = ["x.py:1"] * (len(trace.reads) + len(trace.uploads))
        ok = contracts.RouteRun(run.route, run.label, run.kernel, run.units, trace, run.expected)
        assert contracts.check_run(ok) == []
        trace.syncs = trace.syncs + ["stats.py:9"]
        [finding] = contracts.check_run(ok)
        assert finding.snippet.endswith(":syncs") and "does not predict" in finding.message

    def test_failed_and_unrun_entry_points_are_findings(self, monkeypatch):
        from iterative_cleaner_tpu_torch.backends import torch_backend as tb

        def boom(*args, **kwargs):
            raise RuntimeError("seeded")

        monkeypatch.setattr(tb, "fused_clean", boom)
        monkeypatch.setitem(contracts.ROUTE_HOST_READS, "extra", {"never_run": ()})
        snippets = {f.snippet for f in contracts.check_routes("cpu")}
        assert "fused:fused_clean:run-failure" in snippets
        assert "extra:never_run:untraced" in snippets

    @pytest.mark.parametrize("call,want", [
        (lambda d, h: d.sum().item(), "read"),
        (lambda d, h: d.tolist(), "read"),
        (lambda d, h: bool(d[0] > 0), "read"),
        (lambda d, h: d.to("cpu"), "read"),
        (lambda d, h: h.copy_(d), "read"),
        (lambda d, h: h.tolist(), None),
        (lambda d, h: h.to("cpu"), "upload"),
        (lambda d, h: d.copy_(h), "upload"),
        (lambda d, h: d.__setitem__(slice(0, 4), h), "upload"),
        (lambda d, h: d.copy_(h, non_blocking=True), None),
        (lambda d, h: d.to(torch.float32), None),
        (lambda d, h: torch.tensor([1.0], device="cpu"), "upload"),
        (lambda d, h: d + 1, None),
    ])
    def test_transfer_kinds(self, call, want):
        """What the modes count, on the CPU: a tensor the route holds is
        device data, one wrapped from a host array host data."""
        trace = contracts.Trace("cpu")
        d = torch.ones(4)
        h = torch.from_numpy(np.zeros(4, np.float32))
        with trace.resident(d):
            call(d, h)
        got = ["read"] * len(trace.reads) + ["upload"] * len(trace.uploads)
        assert got == ([want] if want else [])

    def test_contract_fingerprints_distinguish_violation_kinds(self):
        kinds = ("reads", "uploads", "syncs", "dtype")
        prints = {contracts._finding("fused", "fused_clean", k, "m").fingerprint for k in kinds}
        assert len(prints) == len(kinds)

    def test_expected_counts(self):
        lines = contracts.ROUTE_HOST_READS["stepwise"]["TorchCleaner.step"]
        assert contracts.expected_counts(lines, {"run": 1, "iteration": 3,
                                                 "later iteration": 2}) == {
            "read": 8, "upload": 5}


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-q"]))
