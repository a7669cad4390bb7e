#!/usr/bin/env python3
"""Replay a divergence repro bundle of the PyTorch port.

    python3 tools_torch/replay_repro.py <bundle_dir> [--device cuda]

The counterpart of ``tools/replay_repro.py``, importing nothing of JAX, so it
runs on the card.  A bundle (``obs/audit.write_repro_bundle``: the CLI's
``--audit``, the serving replica's shadow auditor, or
``tools_torch/fuzz_sweep.py``) holds the preprocessed cube and weights, the
exact CleanConfig, versions and trace context.  The tool re-executes it:

1. the port's **numpy oracle** on the bundle's inputs (then the bad-parts
   sweep, as every route's output gets it);
2. the **recorded torch route** (the bundle's own CleanConfig, on
   ``--device``, default ``cuda``) live — a divergence the code causes
   CONFIRMS, one that came from transient corruption or an injected fault in
   the capturing process CLEARS; a bundle of the batched route
   (``coalesced`` or ``sharded`` in its route) also replays that route, a
   ``sharded`` one on the fuzz's 8 logical devices of ``--device``;
3. the **recorded served mask**, when the bundle has one, against the fresh
   oracle.

Prints one JSON line, the JAX tool's keys:

    {"repro": "confirmed" | "cleared", "live_mask_identical": ...,
     "recorded_mask_matches_oracle": ..., ...}

Exit codes: 0 = the live route agrees with the oracle (cleared), 1 = it
still diverges (confirmed), 2 = an unusable bundle or a usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def replay(bundle_dir: str, device: str = "cuda") -> dict:
    """Re-execute one bundle; returns the verdict payload (raises on an
    unreadable bundle: :func:`main` makes that rc 2)."""
    from iterative_cleaner_tpu_torch.backends.torch_backend import resolve_device
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.models.surgical import finalize_weights
    from iterative_cleaner_tpu_torch.obs import audit

    manifest, arrays = audit.load_repro_bundle(bundle_dir)
    cfg = audit.config_from_manifest(manifest)
    D, w0 = arrays["D"], arrays["w0"]
    dev = resolve_device(device)

    cfg_np = audit.oracle_config(cfg)
    res_np = clean_cube(D, w0, cfg_np)
    oracle_w, _nbs, _nbc = finalize_weights(res_np.weights, cfg_np)

    out = {
        "bundle": bundle_dir,
        "reason": manifest.get("reason", ""),
        "route": manifest.get("route", ""),
        "trace_id": manifest.get("trace_id", ""),
        "cube_shape": list(D.shape),
        "oracle_loops": int(res_np.loops),
        "captured_versions": manifest.get("versions", {}),
        "device": str(dev),
    }

    # The recorded incident: does the mask the original process served
    # still differ from a fresh oracle run?  (None without one.)
    served = arrays.get("weights_served")
    if served is not None:
        n = int(np.sum(served != oracle_w))
        out["recorded_mask_matches_oracle"] = n == 0
        out["n_recorded_diffs"] = n
    else:
        out["recorded_mask_matches_oracle"] = None

    # The live question: does the recorded route, rerun on this tree and
    # this device, still diverge?
    live_cfg = cfg.replace(backend="torch", audit=False)
    res_live = clean_cube(D, w0, live_cfg, device=dev)
    live_w, _nbs, _nbc = finalize_weights(res_live.weights, live_cfg)
    live_diffs = {"clean_cube": int(np.sum(live_w != oracle_w))}
    out["live_loops"] = int(res_live.loops)
    route = str(manifest.get("route", ""))
    if "coalesced" in route or "sharded" in route:
        from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh
        from iterative_cleaner_tpu_torch.parallel.sharded import sharded_clean_single

        n = 8 if "sharded" in route else 1
        _t, w_sh, _loops, _done = sharded_clean_single(
            D, w0, live_cfg.replace(chunk_block=0, fused=False), make_mesh(devices=[dev] * n))
        w_sh, _nbs, _nbc = finalize_weights(np.asarray(w_sh), live_cfg)
        live_diffs["sharded"] = int(np.sum(w_sh != oracle_w))
    n_live = max(live_diffs.values())
    out["live_mask_identical"] = n_live == 0
    out["n_live_diffs"] = n_live
    out["live_diffs_by_route"] = live_diffs
    out["repro"] = "cleared" if n_live == 0 else "confirmed"
    if served is not None and n_live == 0 and out["n_recorded_diffs"]:
        out["note"] = ("the recorded served mask differs from the oracle but a live "
                       "rerun does not: the divergence was transient in the capturing "
                       "process (or injected), not reproducible from the inputs")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the live rerun (default: cuda)")
    try:
        args = ap.parse_args(argv)
    except SystemExit:
        return 2
    try:
        out = replay(args.bundle, args.device)
    except Exception as exc:  # noqa: BLE001 — one-line contract, rc 2
        print(json.dumps({"repro": "error", "error": f"{type(exc).__name__}: {exc}",
                          "bundle": args.bundle}))
        return 2
    print(json.dumps(out))
    return 1 if out["repro"] == "confirmed" else 0


if __name__ == "__main__":
    sys.exit(main())
