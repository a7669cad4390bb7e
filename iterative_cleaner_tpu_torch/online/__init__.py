"""The online subsystem: subint blocks in, provisional alerts, canonical end.

Port of ``iterative_cleaner_tpu/online/``.  Subint blocks arrive
incrementally (the CLI's ``--follow`` file tail, ``online/follow.py``); a
resident per-session :class:`CleanState` grows by amortized doubling, every
block triggers a bounded provisional clean pass with zap alerts (advisory,
latency first), and end-of-stream runs the canonical pipeline on the
completed cube, so the authoritative mask stays identical to the numpy
oracle by construction (``online/finalize.py``).  ``online/blocks.py`` is
the block wire format of the serving daemon's session API
(``service/sessions.py``).
"""

from iterative_cleaner_tpu_torch.online.finalize import FinalizedSession, finalize_session
from iterative_cleaner_tpu_torch.online.session import OnlineSession, ZapAlert
from iterative_cleaner_tpu_torch.online.state import CleanState, SessionMeta

__all__ = [
    "CleanState",
    "FinalizedSession",
    "OnlineSession",
    "SessionMeta",
    "ZapAlert",
    "finalize_session",
]
