"""The comparison that decides ``correct``.

Every answer that the window produced is held against the plain reference
of its input.  An answer is a list of parts, one per clean it holds (one,
or one per threshold pair of a sweep); a part is the final weights, the
last iteration's scores and the loop count.  Four numbers, each with its
limit (``PERF.md`` gives the readings each limit was set from):

- ``missing``: inputs submitted in the window whose answer never came (the
  call raised), and parts absent from an answer; exact, limit 0;
- ``mask_diff``: the most profiles whose final weight differs from the
  reference's, in any part; exact, limit 0 (the cleaner promises the
  oracle's mask);
- ``loops_diff``: parts whose loop count differs from the reference's;
  exact, limit 0;
- ``score_drift``: the widest gap of a score from the reference's score, as
  a share of the reference's magnitude floored at 1, over every part; a
  score that is NaN or infinite on one side and not the same on the other
  reads as infinite.
"""

from __future__ import annotations

import numpy as np

#: Limits of the numbers compared, the same in every cell.
LIMITS = {"missing": 0, "mask_diff": 0, "loops_diff": 0, "score_drift": 5.0e-5}


def score_drift(got: np.ndarray, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(got)):
        return float("inf")
    odd = ~fin
    if odd.any() and not np.array_equal(np.nan_to_num(got[odd]), np.nan_to_num(want[odd])):
        return float("inf")
    if not fin.any():
        return 0.0
    gap = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    return float(gap.max())


def compare_parts(got: list[dict], want: list[dict]) -> dict:
    """The four numbers for one answer against its reference."""
    out = {"missing": max(0, len(want) - len(got)), "mask_diff": 0, "loops_diff": 0,
           "score_drift": 0.0}
    for g, w in zip(got, want):
        gw, ww = np.asarray(g["weights"]), np.asarray(w["weights"])
        if gw.shape != ww.shape:
            out["mask_diff"] = max(out["mask_diff"], int(ww.size))
        else:
            out["mask_diff"] = max(out["mask_diff"], int(np.count_nonzero(gw != ww)))
        out["loops_diff"] += int(int(g["loops"]) != int(w["loops"]))
        out["score_drift"] = max(out["score_drift"], score_drift(g["scores"], w["scores"]))
    return out


def worst(readings: list[dict], missing: int = 0) -> dict:
    """The worst of each number over all answers, with ``missing`` answers."""
    out = {"missing": missing, "mask_diff": 0, "loops_diff": 0, "score_drift": 0.0}
    for r in readings:
        out["missing"] += r["missing"]
        out["mask_diff"] = max(out["mask_diff"], r["mask_diff"])
        out["loops_diff"] += r["loops_diff"]
        out["score_drift"] = max(out["score_drift"], r["score_drift"])
    return out


def judge(numbers: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at or under its limit in ``LIMITS`` (a NaN never is)."""
    checks = {k: {"value": numbers[k], "limit": v} for k, v in LIMITS.items()}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
