"""The control of the check: the reference put in the program's place.

    python3 bench_port/control.py --workload <name> --seeds <n> [<n> ...] [--json PATH]

For each seed it makes the cell's inputs as a run with that seed makes them,
answers each with the reference computed one precision below the
configuration's float32 (TF32: float32 with the operands of every product
sum rounded to 10 mantissa bits), and compares those answers with the
reference's float64 ones by ``compare.py``, as a run compares the
program's.  One JSON line per seed, then one with the worst of each number
and whether the control came out not correct, as it has to.  It runs on the
card (``cuda:0``) when there is one, else on the CPU.
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_readings(workload: str, seeds, device, root=None) -> list[dict]:
    import torch

    from bench_port import compare, harness

    root = Path(root) if root is not None else harness.REPO
    spec = harness.load_spec(root)
    _cell, config, traffic = harness.find_cell(spec, workload, root)
    entry = harness.make_entry(config, traffic, device, root)
    out = []
    for seed in seeds:
        readings = []
        for src in entry.sources(int(seed)):
            inp = entry.make(src)
            want = entry.reference(inp, "float64")
            got = entry.reference(inp, "tf32")
            readings.append(compare.compare_parts(got, want))
            del inp, want, got
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        numbers = compare.worst(readings)
        correct, _ = compare.judge(numbers)
        out.append({"seed": int(seed), **numbers, "correct": correct})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)

    import torch

    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    rows = control_readings(args.workload, args.seeds, device)
    for r in rows:
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "device": device,
               "score_drift_min": min(r["score_drift"] for r in rows),
               "mask_diff_min": min(r["mask_diff"] for r in rows),
               "all_not_correct": not any(r["correct"] for r in rows)}
    print(json.dumps(summary), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
