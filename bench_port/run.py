"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench_port/``
and the program, ``iterative_cleaner_tpu_torch/``.  It needs an NVIDIA card
(``torch.cuda``) and the cards the cell asks for; without them it exits
with code 2 and prints no result.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``: each
number compared beside its limit, which are also the last lines of
standard error).  A run that loads JAX or the JAX package exits with code
3 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_port import harness

    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda:0", t_start=T_START, spec=spec)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the port's benchmark may load none of "
              f"{list(harness.FORBIDDEN)}", file=sys.stderr)
        return 3
    for line in out.pop("_stderr"):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
