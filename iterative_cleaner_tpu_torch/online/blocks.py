"""Block wire format — one codec for the HTTP body and the session spool.

A copy of ``iterative_cleaner_tpu/online/blocks.py`` over the port's
:mod:`..ingest.codec`.

A block is two arrays, ``data`` (bsub, npol, nchan, nbin) and ``weights``
(bsub, nchan).  Since the ingest tier landed they travel as a compressed
self-describing container (:mod:`..ingest.codec`: byteshuffle + DEFLATE,
zstd when available — lossless, bit-exact f32 round-trip) so the
spool/session path moves a fraction of the raw bytes over slow links;
``ICT_WIRE_CODEC=npz`` reverts to the legacy in-memory NPZ container.
Decoding sniffs the container magic, so spools written by older daemons
and uploads from older clients replay through the identical path — the
daemon still persists received bytes VERBATIM as the session's replay log,
and decode validates the payload once for both the live and replayed copy.
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_tpu_torch.ingest.codec import decode_payload, encode_arrays

#: Upload clamp for one block body (the service applies it to
#: Content-Length): a 256 MB f32 block is ~1M profiles of 64 bins — far
#: beyond any per-block observatory cadence — while an unbounded read
#: would let one client buffer the daemon out of host RAM.  The clamp
#: applies to WIRE bytes; decode then caps the total RAW bytes the
#: container's header may declare at MAX_RAW_BLOCK_BYTES, with each
#: stream's inflation bounded to its declared size *during*
#: decompression — so a crafted payload can neither over-declare nor
#: over-inflate.
MAX_BLOCK_BYTES = 256 << 20

#: Decode-side cap on a block's declared raw size: 4x the wire clamp
#: covers every legitimate compression ratio on real f32 radio data (the
#: codec measures ~0.85; even pathological repetitive cubes stay well
#: inside 4:1) while bounding a decompression bomb to 1 GB.
MAX_RAW_BLOCK_BYTES = MAX_BLOCK_BYTES * 4


def encode_block(data: np.ndarray, weights: np.ndarray,
                 codec: str | None = None) -> bytes:
    return encode_arrays(
        {"data": np.asarray(data, np.float32),
         "weights": np.asarray(weights, np.float32)}, codec=codec)


def decode_block(payload: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Bytes → (data, weights); raises ValueError on anything malformed
    (the API maps that to a 400, never a dropped socket)."""
    arrays = decode_payload(payload, max_raw_bytes=MAX_RAW_BLOCK_BYTES)
    try:
        return (np.asarray(arrays["data"], np.float32),
                np.asarray(arrays["weights"], np.float32))
    except KeyError as exc:
        raise ValueError(f"block payload missing array {exc}") from None
