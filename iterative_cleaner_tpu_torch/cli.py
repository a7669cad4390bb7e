"""Command-line interface of the PyTorch port.

Port of ``iterative_cleaner_tpu/cli.py``: the reference flag surface
(``-c -s -m -r -o -p -u -q -l --memory --bad_chan --bad_subint``) plus
``--backend {numpy,torch}`` (default torch), ``--device`` (default cuda),
``--kernel/--no_kernel``, ``--fused``, ``--chunk_block``, ``--no_auto_shard``,
``--no_incremental_template``, ``--sharded_batch``, ``--stream``,
``--resume``, ``--follow`` (with ``--follow_poll``, ``--follow_timeout``,
``--alert_iters``), ``--sweep``, ``--audit``, ``--dump_masks``, ``--report``,
``--telemetry``, ``--trace``, ``-z/--print_zap`` and ``--x64``.  Archives
are ``.npz``, ``.ictb`` or, with the ``psrchive`` bindings, PSRCHIVE
``.ar``.  The exit code is 1 when any archive failed,
2 for a usage error.  A sub-command as the first argument runs instead of
a clean (the JAX ``cli.py`` dispatch): ``serve`` the serving daemon
(``service/daemon.serve_main``, also ``ict-serve-torch``), ``serve-fleet``
the fleet router (``fleet/router.fleet_main``, also
``ict-serve-fleet-torch``), ``campaign`` the campaign follow client,
``prove`` the proving ground, ``explain`` a job's causal report and
``trends`` the router's performance trends.

Every run mints a trace id and wraps its work in the ``cli_run`` span, so
the events of one invocation share it (``--telemetry`` / ``ICT_TELEMETRY``
names the JSON-lines sink).  On the card the run sits under the CUDA
initialisation watchdog (``utils/device_probe.init_watchdog``).

Run as ``python -m iterative_cleaner_tpu_torch`` or ``ict-clean-torch``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from iterative_cleaner_tpu_torch.config import CleanConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ict-clean-torch",
        description="Iterative surgical RFI cleaner for pulsar archives "
                    "(PyTorch / CUDA)",
    )
    p.add_argument("archive", nargs="+",
                   help="archives to clean (.npz, .ictb, or .ar with psrchive)")
    p.add_argument(
        "-c", "--chanthresh", type=float, default=5, metavar="channel_threshold",
        help="sigma threshold for a profile to stand out against others in "
             "the same channel (default: 5)")
    p.add_argument(
        "-s", "--subintthresh", type=float, default=5, metavar="subint_threshold",
        help="sigma threshold for a profile to stand out against others in "
             "the same subint (default: 5)")
    p.add_argument(
        "-m", "--max_iter", type=int, default=5, metavar="maximum_iterations",
        help="maximum number of cleaning iterations (default: 5; must be >= 1)")
    p.add_argument("-z", "--print_zap", action="store_true",
                   help="save a plot showing which profiles were zapped (needs "
                        "matplotlib)")
    p.add_argument("-u", "--unload_res", action="store_true",
                   help="save an archive containing the pulse-free residual")
    p.add_argument("-p", "--pscrunch", action="store_true",
                   help="pscrunch the output archive")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="do not print cleaning information")
    p.add_argument("-l", "--no_log", action="store_true",
                   help="do not append to clean.log")
    p.add_argument(
        "-r", "--pulse_region", nargs=3, type=float, default=[0, 0, 1],
        metavar=("scaling_factor", "pulse_start", "pulse_end"),
        help="suppress residuals in phase bins [pulse_start:pulse_end] "
             "(dedispersed frame) by scaling_factor; 0 0 1 disables. NOTE: "
             "the scaling factor comes FIRST — the order the original "
             "implementation actually reads, despite its help text")
    p.add_argument(
        "-o", "--output", type=str, default="", metavar="output_filename",
        help="output name; 'std' uses the pattern NAME.FREQ.MJD")
    p.add_argument("--memory", action="store_true",
                   help="compatibility no-op (the in-memory archive is never "
                        "mutated, so no reload is needed)")
    p.add_argument("--bad_chan", type=float, default=1,
                   help="zap a whole channel when its zapped-subint fraction "
                        "strictly exceeds this (default 1 = never)")
    p.add_argument("--bad_subint", type=float, default=1,
                   help="zap a whole subint when its zapped-channel fraction "
                        "strictly exceeds this (default 1 = never)")
    p.add_argument("--backend", choices=("numpy", "torch"), default="torch",
                   help="compute backend (default: torch)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; fails when there is no "
                        "CUDA device — pass 'cpu' to run on the CPU)")
    p.add_argument("--kernel", action="store_const", const=True, default=None,
                   dest="kernel",
                   help="force the hand-written CUDA fit/moments kernel "
                        "(default: auto — on whenever the device is CUDA, the "
                        "shape fits and no residual is requested)")
    p.add_argument("--no_kernel", action="store_const", const=False, dest="kernel",
                   help="use the plain PyTorch route instead of the kernel")
    p.add_argument("--x64", action="store_true",
                   help="torch: float64 intermediates (torch has float64 "
                        "natively, so no environment switch is needed; the "
                        "fit/moments kernel is float32 only and stays off)")
    p.add_argument("--fused", action="store_true",
                   help="torch: run the whole iteration loop on the device, "
                        "one host read per iteration (per-loop progress is "
                        "derived afterwards from the on-device mask history)")
    p.add_argument("--no_auto_shard", action="store_true",
                   help="torch: never stream an oversized cube through the "
                        "device (default: a cube whose working set exceeds "
                        "the card's memory is cleaned in subint blocks)")
    p.add_argument("--chunk_block", type=int, default=0, metavar="N",
                   help="torch: force the single-device streaming backend with "
                        "N-subint blocks, regardless of the device-memory "
                        "estimate (0 = automatic; the escape hatch when the "
                        "working-set estimate or reported memory is off)")
    p.add_argument("--no_incremental_template", action="store_true",
                   help="torch: rebuild the template densely every iteration "
                        "instead of carrying it across iterations and updating "
                        "it from the flipped profiles (the incremental update "
                        "saves one full cube read per iteration after the "
                        "first; masks are identical across both routes)")
    p.add_argument("--sharded_batch", action="store_true",
                   help="torch: clean same-shape archives together on the card, "
                        "one kernel launch per iteration over all of them (a "
                        "bucket larger than the card's memory goes in several "
                        "dispatches)")
    p.add_argument("--resume", action="store_true",
                   help="skip archives whose cleaned output already exists "
                        "(rerun an interrupted batch; default naming mode only)")
    p.add_argument("--stream", action="store_true",
                   help="with --sharded_batch: the bounded-host-residency batch "
                        "loader — dispatch each same-shape bucket as soon as its "
                        "archives are decoded, overlapping host I/O with device "
                        "compute (default: load the whole directory first, "
                        "unless it is larger than a quarter of host memory)")
    p.add_argument("--follow", action="store_true",
                   help="online mode: tail each archive as it GROWS on disk (a "
                        "writer atomically rewriting it with more subints), "
                        "emit provisional zap alerts within one poll of each "
                        "block landing, and at end-of-stream (<archive>.eos "
                        "sentinel, or no growth for --follow_timeout) run the "
                        "canonical clean on the completed file — the final "
                        "mask is the ordinary offline result; the alerts are "
                        "advisory")
    p.add_argument("--follow_poll", type=float, default=1.0, metavar="S",
                   help="--follow: seconds between growth polls (default 1)")
    p.add_argument("--follow_timeout", type=float, default=30.0, metavar="S",
                   help="--follow: end-of-stream after this many seconds "
                        "without growth when no .eos sentinel appears "
                        "(default 30)")
    p.add_argument("--alert_iters", type=int, default=2, metavar="N",
                   help="--follow: provisional clean-pass iterations per "
                        "ingested block (default 2)")
    p.add_argument("--sweep", nargs="+", default=None, metavar="C:S",
                   help="threshold sweep mode: clean each archive under every "
                        "given chanthresh:subintthresh pair in one batched "
                        "device dispatch; prints a rfi_frac/loops table per "
                        "archive and saves <archive>_sweep.npz with all "
                        "masks. No cleaned archives are written in this mode")
    p.add_argument("--audit", action="store_true",
                   help="after each archive, replay it through the numpy "
                        "oracle and compare the final masks and scores; a "
                        "divergence prints loudly and writes a repro bundle "
                        "(ICT_REPRO_DIR, default ./ict_repro)")
    p.add_argument("--dump_masks", action="store_true",
                   help="save the per-iteration mask history as "
                        "<output>_masks.npz")
    p.add_argument("--report", type=str, default="", metavar="PATH",
                   help="write a JSON run report (one object per archive)")
    p.add_argument("--trace", type=str, default="", metavar="DIR",
                   help="write a torch.profiler capture (Chrome trace JSON) of "
                        "each clean to DIR")
    p.add_argument("--telemetry", type=str, default="", metavar="PATH",
                   help="append structured telemetry events (trace context, "
                        "route decisions, per-iteration convergence "
                        "forensics) to PATH as JSON lines (ICT_TELEMETRY "
                        "equivalent); ICT_FORENSICS=1 adds per-diagnostic "
                        "zap attribution")
    return p


def config_from_args(args: argparse.Namespace) -> CleanConfig:
    return CleanConfig(
        chanthresh=args.chanthresh,
        subintthresh=args.subintthresh,
        max_iter=args.max_iter,
        pulse_region=tuple(args.pulse_region),
        bad_chan=args.bad_chan,
        bad_subint=args.bad_subint,
        output=args.output,
        pscrunch=args.pscrunch,
        memory=args.memory,
        unload_res=args.unload_res,
        print_zap=args.print_zap,
        quiet=args.quiet,
        no_log=args.no_log,
        backend=args.backend,
        kernel=args.kernel,
        x64=args.x64,
        fused=args.fused,
        auto_shard=not args.no_auto_shard,
        chunk_block=args.chunk_block,
        incremental_template=not args.no_incremental_template,
        sharded_batch=args.sharded_batch,
        stream=args.stream,
        resume=args.resume,
        dump_masks=args.dump_masks,
        audit=args.audit,
        trace_dir=args.trace,
    )


def parse_sweep_pairs(specs: list[str]) -> list[tuple[float, float]]:
    pairs = []
    for spec in specs:
        try:
            c, s = spec.split(":")
            pairs.append((float(c), float(s)))
        except ValueError:
            raise ValueError(
                f"bad --sweep pair {spec!r}; expected chanthresh:subintthresh "
                "like 5:5") from None
    return pairs


#: Printed by ``--x64 --audit``: the audit's oracle is float32, so the
#: float64 route's scores sit the oracle's own rounding away from it.
X64_AUDIT_NOTE = (
    "note: --audit compares --x64 scores with the float32 numpy oracle; its "
    "score-drift bound ({bound}) is the float32 routes' envelope and does not "
    "apply to float64 scores, which may count as audit_drift_exceeded while "
    "the mask comparison stays exact")


#: Sub-command -> (module under the package, its ``main(argv)``).
SUBCOMMANDS = {
    "serve": ("service.daemon", "serve_main"),
    "serve-fleet": ("fleet.router", "fleet_main"),
    "campaign": ("campaign.cli", "campaign_main"),
    "prove": ("proving.soak", "prove_main"),
    "explain": ("fleet.explain", "explain_main"),
    "trends": ("fleet.trends", "trends_main"),
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in SUBCOMMANDS and not os.path.isfile(argv[0]):
        # Dispatched on the literal first token — unless a regular FILE of
        # that name exists in cwd (a directory can never be an archive
        # positional), in which case the reference semantics win; the
        # ``ict-serve-torch`` / ``ict-serve-fleet-torch`` scripts are the
        # unambiguous entry points.
        import importlib

        module, func = SUBCOMMANDS[argv[0]]
        mod = importlib.import_module(f"iterative_cleaner_tpu_torch.{module}")
        return getattr(mod, func)(argv[1:])
    args = build_parser().parse_args(argv)
    try:
        cfg = config_from_args(args)
        sweep_pairs = parse_sweep_pairs(args.sweep) if args.sweep else None
        if args.follow and (args.sharded_batch or args.sweep):
            raise ValueError("--follow tails growing single archives and "
                             "cannot combine with --sharded_batch/--sweep")
        if args.follow and args.alert_iters < 1:
            raise ValueError(f"--alert_iters must be >= 1, got {args.alert_iters}")
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if cfg.audit and cfg.x64:
        from iterative_cleaner_tpu_torch.obs.audit import AUDIT_DRIFT_BOUND

        print(X64_AUDIT_NOTE.format(bound=AUDIT_DRIFT_BOUND), file=sys.stderr)
    from iterative_cleaner_tpu_torch import driver
    from iterative_cleaner_tpu_torch.obs import events
    from iterative_cleaner_tpu_torch.utils.device_probe import init_watchdog

    if args.telemetry:
        events.configure(args.telemetry)
    on_card = cfg.backend == "torch" and args.device.split(":")[0] == "cuda"
    watchdog = init_watchdog("cli cuda init") if on_card else contextlib.nullcontext()
    with watchdog, events.trace_scope(events.new_trace_id()), \
            events.span("cli_run", argv=list(argv)):
        if sweep_pairs is not None:
            reports = driver.run_sweep(args.archive, cfg, sweep_pairs, device=args.device)
        elif args.follow:
            reports = driver.run_follow(args.archive, cfg, poll_s=args.follow_poll,
                                        idle_timeout_s=args.follow_timeout,
                                        alert_iters=args.alert_iters, device=args.device)
        else:
            reports = driver.run(args.archive, cfg, device=args.device)
    if args.report:
        driver.write_report(reports, args.report, cfg)
    return 0 if all(r.error is None for r in reports) else 1


if __name__ == "__main__":
    raise SystemExit(main())
