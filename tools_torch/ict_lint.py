#!/usr/bin/env python
"""ict-lint for the PyTorch port: the static analysis suite's CLI.

The port of ``tools/ict_lint.py`` (same flags, same exit codes), over the
port's tree — ``iterative_cleaner_tpu_torch/``, ``tools_torch/`` and
``chip_smoke.py`` — with the port's baseline.  Layers:

- ``--source``     AST lint rules (ICT000-ICT003, ICT005) — offline, no
                   torch import;
- ``--races``      the race detector over the threaded modules (ICT007
                   guarded-by, ICT008 lock-order) — offline;
- ``--contracts``  the torch route contracts (ICT009: host reads against
                   the ledger, no 64-bit float on the float32 routes; on
                   ``--device cuda`` the card's syncs too) — imports torch
                   and runs every route on a tiny cube;
- ``--all``        everything.

Default with no layer flag: source + races (the fast offline pair).
``--device`` is where the contracts run: ``cuda`` by default, as every
entry point of the port (no card is an error, exit 2); ``cpu`` here:

    python tools_torch/ict_lint.py --all --device cpu

Exit status: 0 when every finding is baselined
(tools_torch/ict_lint_baseline.json), 1 otherwise, 2 on usage errors.
``--fix`` applies mechanical remedies (today: appending a ``guarded-by``
annotation when every observed write already sits under one consistent
lock) and re-reports; ``--write-baseline`` snapshots current findings —
every entry then needs a hand-written justification to survive review.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ict-lint-torch",
        description="invariant-aware static analysis "
                    "(lint / race detector / route contracts)")
    p.add_argument("paths", nargs="*",
                   help="restrict the source/race layers to these files "
                        "(default: the whole project)")
    p.add_argument("--all", action="store_true",
                   help="run every layer (source + races + contracts)")
    p.add_argument("--source", action="store_true",
                   help="AST source rules (ICT000-ICT003, ICT005)")
    p.add_argument("--races", action="store_true",
                   help="race detector over the threaded modules (ICT007, ICT008)")
    p.add_argument("--contracts", action="store_true",
                   help="torch route contracts (ICT009; imports torch and runs "
                        "every route on a tiny cube on --device)")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where --contracts runs the routes (default: cuda, the "
                        "card; no card is an error)")
    p.add_argument("--fix", action="store_true",
                   help="apply mechanical remedies, then re-run")
    p.add_argument("--baseline",
                   default=os.path.join(REPO_ROOT, "tools_torch",
                                        "ict_lint_baseline.json"),
                   help="baseline suppression file (default: "
                        "tools_torch/ict_lint_baseline.json)")
    p.add_argument("--write-baseline", action="store_true",
                   help="snapshot current findings into the baseline")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="findings only, no summary chatter")
    return p


def select_layers(args) -> dict[str, bool]:
    """The ONE place the layer-selection rule lives (default with no
    layer flag: the fast offline pair)."""
    return {
        "source": args.source or args.all
        or not (args.races or args.contracts),
        "races": args.races or args.all
        or not (args.source or args.contracts),
        "contracts": args.contracts or args.all,
    }


def gather_findings(args, root: str, layers: dict[str, bool]):
    from iterative_cleaner_tpu_torch.analysis.engine import (
        collect_project_files,
        load_source_file,
    )

    findings = []
    if layers["source"] or layers["races"]:
        relpaths = collect_project_files(root, args.paths or None)
        files = [load_source_file(root, rel) for rel in relpaths]
        if layers["source"]:
            from iterative_cleaner_tpu_torch.analysis.rules import run_source_rules

            findings.extend(run_source_rules(files))
        if layers["races"]:
            from iterative_cleaner_tpu_torch.analysis.races import run_race_rules

            findings.extend(run_race_rules(files))
    if layers["contracts"]:
        from iterative_cleaner_tpu_torch.analysis.contracts import check_routes

        findings.extend(check_routes(args.device))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    root = REPO_ROOT

    from iterative_cleaner_tpu_torch.analysis.engine import (
        apply_fixes,
        load_baseline,
        split_baselined,
        write_baseline,
    )

    layers = select_layers(args)
    if layers["contracts"]:
        from iterative_cleaner_tpu_torch.backends.torch_backend import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as exc:
            print(f"ict-lint: {exc}", file=sys.stderr)
            return 2
    findings = gather_findings(args, root, layers)
    if args.fix:
        n = apply_fixes(root, findings)
        if n and not args.quiet:
            print(f"ict-lint: --fix annotated {n} line(s); re-checking",
                  file=sys.stderr)
        if n:
            # Annotation fixes can only change source/race results; carry
            # the first pass's contract findings forward instead of
            # running every route again.
            contract_findings = [f for f in findings
                                 if f.rule.startswith("ICT009")]
            findings = gather_findings(
                args, root, {**layers, "contracts": False})
            findings.extend(contract_findings)
            findings.sort(key=lambda f: (f.path, f.line, f.rule))

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        if not args.quiet:
            print(f"ict-lint: wrote {len(findings)} finding(s) to "
                  f"{args.baseline}", file=sys.stderr)
        return 0

    baseline = load_baseline(args.baseline)
    fresh, suppressed = split_baselined(findings, baseline)
    for f in fresh:
        print(f.render())
    if not args.quiet:
        ran = [name for name, on in layers.items() if on]
        print(f"ict-lint: {len(fresh)} finding(s) "
              f"({len(suppressed)} baselined) across "
              f"{'+'.join(ran)}", file=sys.stderr)
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
