"""Full-jitter retry backoff, shared by every retry ladder in the tree.

A copy of ``iterative_cleaner_tpu/utils/backoff.py``: the same draws under
the same ``ICT_BACKOFF_SEED``.

The worker's original ladder slept a deterministic ``base * 2**attempt``
— fine for one daemon, wrong for a fleet: N replicas (or the router's N
queued failovers) recovering from the same incident all wake on the same
schedule and thundering-herd the spool / the revived replica.  Full
jitter (sleep ``uniform(0, min(cap, base * 2**attempt))``) decorrelates
the retriers while keeping the same expected growth.

Determinism for tests: every caller owns a :class:`random.Random` built
by :func:`make_rng` — seeded from ``ICT_BACKOFF_SEED`` when set (the
test hook; the fleet tests pin it so retry schedules replay exactly),
OS entropy otherwise.  Mask-path modules never import this (delays are
telemetry-visible wall-clock, never mask-affecting).
"""

from __future__ import annotations

import os
import random
import sys

#: Never sleep longer than this between retries, whatever the attempt
#: count — a ladder that backs off past tens of seconds has effectively
#: given up without saying so.
DEFAULT_CAP_S = 30.0


def make_rng(seed: int | None = None) -> random.Random:
    """A private RNG for one retry ladder.  ``seed`` wins; else
    ``ICT_BACKOFF_SEED`` (the deterministic test hook); else OS entropy.
    Private per caller so two ladders never interleave draws — the
    seeded schedule a test pins must not depend on thread timing."""
    if seed is None:
        env = os.environ.get("ICT_BACKOFF_SEED")
        if env is not None:
            try:
                seed = int(env)
            except ValueError:
                print(f"warning: ignoring unparseable ICT_BACKOFF_SEED="
                      f"{env!r} (want an int)", file=sys.stderr)
    return random.Random(seed)


def full_jitter(base_s: float, attempt: int, cap_s: float = DEFAULT_CAP_S,
                rng: random.Random | None = None) -> float:
    """Delay before retry number ``attempt`` (0-based: the first retry
    draws from ``[0, base_s]``).  Bounded above by ``cap_s``; the 2**62
    clamp keeps a runaway attempt counter from overflowing the float."""
    span = min(float(cap_s),
               float(base_s) * float(2 ** min(max(int(attempt), 0), 62)))
    return (rng or random).uniform(0.0, span)
