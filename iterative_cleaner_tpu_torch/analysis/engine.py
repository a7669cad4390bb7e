"""Shared machinery of the analysis suite: findings, annotations, baseline.

A copy of ``iterative_cleaner_tpu/analysis/engine.py``, aimed at the port's
tree: :func:`collect_project_files` walks ``iterative_cleaner_tpu_torch/``
(never its ``_build/``), ``tools_torch/`` and ``chip_smoke.py``, and the
baseline is ``tools_torch/ict_lint_baseline.json``.

A :class:`Finding` is one rule violation at one source location.  Its
``fingerprint`` is deliberately line-number-free (rule + path + the
stripped source line + the occurrence index of that line-text in the
file), so an unrelated edit above a baselined finding does not resurrect
it — the same stability trick ruff/mypy baselines use.

Annotations are trailing (or immediately-preceding) comments of the form
``# ict: <kind>(<argument>)``; the argument is mandatory — an annotation
without a reason or lock name documents nothing and is itself a finding.
Grammar (the JAX package's docs/ANALYSIS.md; the README's port section):

- ``# ict: guarded-by(<lock>)`` — this state is protected by ``<lock>``
  (``self._lock`` / module ``_lock`` / ``none: <reason>`` for
  deliberately lock-free state, e.g. GIL-atomic idempotent caches);
- ``# ict: backend-init-ok(<reason>)`` — this call, which can start
  CUDA's first initialisation (:data:`.rules.CUDA_INIT_ATTRS`), is guarded
  against the wedged-driver first-init hang, or runs where CUDA is live;
- ``# ict: f64-ok(<reason>)`` — deliberate 64-bit float in a
  mask-affecting module (oracle-parity promotion, x64-gated);
- ``# ict: nondet-ok(<reason>)`` — deliberate wall-clock/RNG use in a
  mask-affecting module (telemetry only, never mask-affecting).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass, field

ANNOTATION_RE = re.compile(r"#\s*ict:\s*([a-z0-9-]+)\(([^)]*)\)")

#: Baseline suppressions live here (tools_torch/ict_lint.py --baseline
#: overrides).
DEFAULT_BASELINE = os.path.join("tools_torch", "ict_lint_baseline.json")

#: What the source and race layers lint: the package (less these
#: directories), the port's tools and its card smoke.
PROJECT_DIRS = ("iterative_cleaner_tpu_torch", "tools_torch")
SKIPPED_DIRS = ("__pycache__", "_build")
PROJECT_FILES = ("chip_smoke.py",)


@dataclass
class Finding:
    rule: str          # e.g. "ICT001/device-init"
    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    message: str
    snippet: str = ""  # stripped source line (fingerprint input)
    occurrence: int = 0  # nth identical snippet in the file
    # Mechanical remedy (--fix): text appended to the flagged line.
    fix_append: str | None = None

    @property
    def fingerprint(self) -> str:
        basis = f"{self.rule}|{self.path}|{self.snippet}|{self.occurrence}"
        return hashlib.sha1(basis.encode()).hexdigest()[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class SourceFile:
    """One parsed file handed to every rule: path, text, per-line
    annotations, and the AST (parsed once)."""

    path: str                       # repo-relative
    abspath: str
    text: str
    lines: list[str] = field(default_factory=list)
    annotations: dict[int, list[tuple[str, str]]] = field(default_factory=dict)
    tree: object | None = None      # ast.Module (None on syntax error)
    parse_error: str = ""

    def annotation(self, lineno: int, kind: str) -> str | None:
        """The argument of a ``kind`` annotation on ``lineno``, or on a
        comment-ONLY line directly above it (the two placements the
        grammar allows — a trailing comment on the *previous statement*
        must not leak onto this one); None when absent."""
        candidates = [lineno]
        above = lineno - 1
        if (1 <= above <= len(self.lines)
                and self.lines[above - 1].strip().startswith("#")):
            candidates.append(above)
        for ln in candidates:
            for k, arg in self.annotations.get(ln, ()):
                if k == kind:
                    return arg
        return None

    def snippet_at(self, lineno: int) -> tuple[str, int]:
        """(stripped line text, occurrence index) — the fingerprint basis."""
        if not (1 <= lineno <= len(self.lines)):
            return "", 0
        text = self.lines[lineno - 1].strip()
        occurrence = sum(
            1 for prior in self.lines[: lineno - 1] if prior.strip() == text)
        return text, occurrence

    def finding(self, rule: str, lineno: int, message: str,
                fix_append: str | None = None) -> Finding:
        snippet, occurrence = self.snippet_at(lineno)
        return Finding(rule=rule, path=self.path, line=lineno,
                       message=message, snippet=snippet,
                       occurrence=occurrence, fix_append=fix_append)


def parse_annotations(text: str) -> dict[int, list[tuple[str, str]]]:
    """Line -> [(kind, argument), ...] for every ``# ict:`` annotation.

    Parsed from raw source rather than the AST so annotations survive on
    lines the compiler drops (comment-only lines above an assignment)."""
    out: dict[int, list[tuple[str, str]]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        for match in ANNOTATION_RE.finditer(line):
            out.setdefault(i, []).append(
                (match.group(1), match.group(2).strip()))
    return out


def load_source_file(root: str, relpath: str) -> SourceFile:
    import ast

    abspath = os.path.join(root, relpath)
    with open(abspath, encoding="utf-8") as fh:
        text = fh.read()
    sf = SourceFile(path=relpath.replace(os.sep, "/"), abspath=abspath,
                    text=text, lines=text.splitlines(),
                    annotations=parse_annotations(text))
    try:
        sf.tree = ast.parse(text, filename=relpath)
    except SyntaxError as exc:  # surfaced as a finding by the runner
        sf.parse_error = str(exc)
    return sf


def collect_project_files(root: str, subset: list[str] | None = None) -> list[str]:
    """Repo-relative paths of every Python file the source layer lints:
    the package (not ``_build/``), ``tools_torch/`` and ``chip_smoke.py``
    (tests and fixtures lint themselves via pytest, not here)."""
    if subset:
        out = []
        for p in subset:
            rel = os.path.relpath(os.path.abspath(p), root)
            out.append(rel.replace(os.sep, "/"))
        return out
    found: list[str] = []
    for top in PROJECT_DIRS:
        for dirpath, dirnames, filenames in os.walk(os.path.join(root, top)):
            dirnames[:] = [d for d in dirnames if d not in SKIPPED_DIRS]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, name), root)
                    found.append(rel.replace(os.sep, "/"))
    for name in PROJECT_FILES:
        if os.path.exists(os.path.join(root, name)):
            found.append(name)
    return sorted(found)


def malformed_annotations(sf: SourceFile) -> list[Finding]:
    """An ``# ict:`` annotation with an empty argument documents nothing —
    the grammar makes the reason/lock mandatory."""
    out = []
    for lineno, anns in sorted(sf.annotations.items()):
        for kind, arg in anns:
            if not arg:
                out.append(sf.finding(
                    "ICT000/annotation-grammar", lineno,
                    f"annotation 'ict: {kind}(...)' needs a non-empty "
                    f"argument (a lock name or a reason)"))
            elif kind not in ("guarded-by", "backend-init-ok", "f64-ok",
                              "nondet-ok"):
                out.append(sf.finding(
                    "ICT000/annotation-grammar", lineno,
                    f"unknown annotation kind 'ict: {kind}(...)' "
                    f"(known: guarded-by, backend-init-ok, f64-ok, "
                    f"nondet-ok)"))
    return out


# --- baseline suppressions ---


def load_baseline(path: str) -> dict[str, dict]:
    """fingerprint -> entry.  A missing file is an empty baseline."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return {}
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write_baseline(path: str, findings: list[Finding]) -> None:
    entries = [
        {"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
         "snippet": f.snippet,
         "note": "baselined by --write-baseline; justify or fix"}
        for f in findings
    ]
    payload = {
        "comment": "Baseline suppressions for tools_torch/ict_lint.py.  "
                   "Every entry must carry a per-finding justification in "
                   "its 'note'; prefer fixing or annotating over "
                   "baselining.",
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=False)
        fh.write("\n")


def split_baselined(findings: list[Finding],
                    baseline: dict[str, dict]) -> tuple[list[Finding], list[Finding]]:
    """(fresh, suppressed) under the baseline."""
    fresh, suppressed = [], []
    for f in findings:
        (suppressed if f.fingerprint in baseline else fresh).append(f)
    return fresh, suppressed


def apply_fixes(root: str, findings: list[Finding]) -> int:
    """Apply mechanical remedies (``fix_append``): append the suggested
    annotation to each flagged line.  Returns how many lines changed."""
    by_file: dict[str, list[Finding]] = {}
    for f in findings:
        if f.fix_append:
            by_file.setdefault(f.path, []).append(f)
    changed = 0
    for relpath, group in by_file.items():
        abspath = os.path.join(root, relpath)
        with open(abspath, encoding="utf-8") as fh:
            lines = fh.read().splitlines(keepends=True)
        for f in sorted(group, key=lambda f: -f.line):
            idx = f.line - 1
            if idx >= len(lines) or f.fix_append in lines[idx]:
                continue
            stripped = lines[idx].rstrip("\n")
            lines[idx] = f"{stripped}  {f.fix_append}\n"
            changed += 1
        with open(abspath, "w", encoding="utf-8") as fh:
            fh.writelines(lines)
    return changed
