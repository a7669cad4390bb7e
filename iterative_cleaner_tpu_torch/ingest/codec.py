"""Lossless f32 wire codec for the spool/session block path.

A copy of ``iterative_cleaner_tpu/ingest/codec.py``: the same container
(magic, JSON header, byte-shuffled DEFLATE or zstd streams) and the same
bytes for the same arrays, so payloads written by either package decode in
both.

The fastest upload is the byte never sent.  Raw f32 radio data
compresses poorly as-is (the mantissa bytes are noise) but its
exponent/sign bytes are highly repetitive, so the codec byte-shuffles
each array -- regrouping byte 0 of every element, then byte 1, ... (the
bitshuffle/blosc trick) -- before a general-purpose entropy coder.
DEFLATE (stdlib zlib) is the floor available everywhere; ``zstandard`` is
used automatically when importable (``ICT_WIRE_CODEC``
overrides: ``npz`` | ``shuffle-zlib`` | ``shuffle-zstd``).

The payload is self-describing (magic + JSON header), and the decoder also
accepts the legacy NPZ container (zip magic), so spools written by older
daemons and uploads from older clients keep replaying byte-for-byte through
the same path.  Round-trips are bit-exact for every f32 value including
NaN/inf payloads -- the codec cannot touch mask parity by construction.
"""

from __future__ import annotations

import io
import json
import struct
import threading
import zlib

import numpy as np

#: Wire magic for the shuffled-compressed container ("ICT Wire v1").
MAGIC = b"ICTW1\x00"

#: Legacy container magic (np.savez writes a zip archive).
_ZIP_MAGIC = b"PK\x03\x04"

#: DEFLATE effort: 6 is zlib's default speed/ratio balance; the wire is
#: tens of MB/s, so heavier settings only pay off on even slower links.
ZLIB_LEVEL = 6

#: Decode-side cap on the TOTAL raw bytes a payload's header may declare
#: (callers pass tighter caps — online/blocks.py does).  DEFLATE inflates
#: up to ~1032:1, so without this a 256 MB wire payload could declare and
#: attempt a ~264 GB allocation; with it, memory is bounded by the cap no
#: matter what the header or the streams claim.
MAX_RAW_BYTES = 4 << 30

try:  # gated optional dependency: zlib is the floor
    import zstandard as _zstd  # type: ignore
except ImportError:  # pragma: no cover - exercised where zstd exists
    _zstd = None

_stats_lock = threading.Lock()
_STATS = {  # ict: guarded-by(_stats_lock)
    "encoded": 0, "raw_bytes_in": 0, "wire_bytes_out": 0,
    "decoded": 0, "wire_bytes_in": 0, "raw_bytes_out": 0,
}


def stats_snapshot() -> dict:
    with _stats_lock:
        s = dict(_STATS)
    s["codec"] = wire_codec_name()
    s["encode_ratio"] = (round(s["wire_bytes_out"] / s["raw_bytes_in"], 4)
                         if s["raw_bytes_in"] else None)
    return s


def reset_stats() -> None:
    with _stats_lock:
        for k in _STATS:
            _STATS[k] = 0


def wire_codec_name() -> str:
    """The codec new payloads are written with (``ICT_WIRE_CODEC``
    override; invalid names fall back to the best available default so a
    typo degrades to a working wire, not a dead daemon)."""
    import os

    name = os.environ.get("ICT_WIRE_CODEC", "")
    if name in ("npz", "shuffle-zlib"):
        return name
    if name == "shuffle-zstd" and _zstd is not None:
        return name
    return "shuffle-zstd" if _zstd is not None else "shuffle-zlib"


def _shuffle(raw: bytes, itemsize: int) -> bytes:
    """Byte-transpose: all byte-0s, then all byte-1s, ...  Same length."""
    u8 = np.frombuffer(raw, np.uint8)
    return np.ascontiguousarray(u8.reshape(-1, itemsize).T).tobytes()


def _unshuffle(raw: bytes, itemsize: int) -> bytes:
    u8 = np.frombuffer(raw, np.uint8)
    return np.ascontiguousarray(u8.reshape(itemsize, -1).T).tobytes()


def _compress(raw: bytes, codec: str) -> bytes:
    if codec == "shuffle-zstd":
        return _zstd.ZstdCompressor().compress(raw)
    return zlib.compress(raw, ZLIB_LEVEL)


def _decompress(raw: bytes, codec: str, n: int) -> bytes:
    """Inflate at most ``n`` bytes (the header-declared array size).

    The bound is enforced DURING decompression, not after: a stream that
    would inflate past its declared size is rejected with at most ``n+1``
    bytes ever materialized, so a crafted stream cannot allocate beyond
    what the header admits to (and the header total is capped before any
    stream is touched — see :func:`_decode_ictw`)."""
    if codec == "shuffle-zstd":
        if _zstd is None:
            raise ValueError(
                "payload compressed with zstd but the zstandard module is "
                "not importable here; re-encode with ICT_WIRE_CODEC="
                "shuffle-zlib or install zstandard")
        # A frame's embedded content size is allocated verbatim by
        # decompress(); reject an over-declared frame before that, and cap
        # unknown-size frames at n.
        try:  # pragma: no cover - exercised where zstd exists
            declared = _zstd.frame_content_size(raw)
        except Exception as exc:  # noqa: BLE001 — malformed frame header
            raise ValueError(f"malformed zstd frame: {exc}") from None
        if declared not in (-1, n):  # pragma: no cover
            raise ValueError(
                f"zstd frame declares {declared} bytes, header admits {n}")
        return _zstd.ZstdDecompressor().decompress(  # pragma: no cover
            raw, max_output_size=max(n, 1))
    out = zlib.decompressobj().decompress(raw, n + 1)
    if len(out) > n:
        raise ValueError(
            f"stream inflates past the {n} bytes its header declares")
    return out


def encode_arrays(arrays: dict[str, np.ndarray],
                  codec: str | None = None) -> bytes:
    """``{name: f32 array} -> wire bytes`` (see the module docstring).

    ``codec=None`` picks :func:`wire_codec_name`; ``"npz"`` writes the
    legacy NPZ container verbatim (the compatibility escape hatch).
    """
    codec = codec or wire_codec_name()
    arrays = {k: np.ascontiguousarray(v, np.float32)
              for k, v in arrays.items()}
    raw_total = sum(a.nbytes for a in arrays.values())
    if codec == "npz":
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        out = buf.getvalue()
    else:
        if codec not in ("shuffle-zlib", "shuffle-zstd"):
            raise ValueError(f"unknown wire codec {codec!r}")
        header = {"codec": codec, "arrays": []}
        streams = []
        for name, a in arrays.items():
            comp = _compress(_shuffle(a.tobytes(), a.itemsize), codec)
            header["arrays"].append({
                "name": name, "shape": list(a.shape),
                "dtype": str(a.dtype), "nbytes": len(comp),
            })
            streams.append(comp)
        head = json.dumps(header, separators=(",", ":")).encode()
        out = b"".join([MAGIC, struct.pack("<I", len(head)), head, *streams])
    with _stats_lock:
        _STATS["encoded"] += 1
        _STATS["raw_bytes_in"] += raw_total
        _STATS["wire_bytes_out"] += len(out)
    return out


def _decode_ictw(payload: bytes,
                 max_raw_bytes: int = MAX_RAW_BYTES) -> dict[str, np.ndarray]:
    off = len(MAGIC)
    if len(payload) < off + 4:
        raise ValueError("truncated ICTW payload (no header length)")
    (hlen,) = struct.unpack_from("<I", payload, off)
    off += 4
    if len(payload) < off + hlen:
        raise ValueError("truncated ICTW payload (header)")
    try:
        header = json.loads(payload[off:off + hlen].decode())
        codec = header["codec"]
        entries = header["arrays"]
    except (ValueError, KeyError, UnicodeDecodeError) as exc:
        raise ValueError(f"malformed ICTW header: {exc}") from None
    off += hlen
    # Parse and size-check EVERY entry before inflating ANY stream: the
    # total the header declares is capped, and each stream's inflation is
    # then bounded to its declared size inside _decompress — so a crafted
    # payload can never allocate past max_raw_bytes.
    parsed = []
    total = 0
    for ent in entries:
        try:
            name, shape = ent["name"], tuple(int(d) for d in ent["shape"])
            dtype, nbytes = np.dtype(ent["dtype"]), int(ent["nbytes"])
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"malformed ICTW array entry: {exc}") from None
        if any(d < 0 for d in shape) or nbytes < 0:
            raise ValueError(f"malformed ICTW array entry for {name!r}")
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        total += n
        if total > max_raw_bytes:
            raise ValueError(
                f"ICTW header declares > {max_raw_bytes} raw bytes "
                f"({total} and counting at array {name!r}) — rejecting "
                f"before decompression")
        parsed.append((name, shape, dtype, nbytes, n))
    out: dict[str, np.ndarray] = {}
    for name, shape, dtype, nbytes, n in parsed:
        if len(payload) < off + nbytes:
            raise ValueError(f"truncated ICTW stream for array {name!r}")
        raw = _unshuffle(_decompress(payload[off:off + nbytes], codec, n),
                         dtype.itemsize)
        if len(raw) != n:
            raise ValueError(
                f"ICTW array {name!r}: {len(raw)} decompressed bytes, "
                f"expected {n} for shape {shape}")
        out[name] = np.frombuffer(raw, dtype).reshape(shape)
        off += nbytes
    return out


def decode_payload(payload: bytes,
                   max_raw_bytes: int = MAX_RAW_BYTES) -> dict[str, np.ndarray]:
    """Wire bytes -> ``{name: array}``; sniffs the container by magic
    (ICTW vs legacy NPZ/zip) and raises ValueError on anything malformed.
    ICTW payloads cannot inflate past ``max_raw_bytes`` total (nor any
    single stream past the size its header declares) — the bound holds
    during decompression, not after it."""
    if payload.startswith(MAGIC):
        try:
            out = _decode_ictw(payload, max_raw_bytes)
        except ValueError:
            raise
        except Exception as exc:  # noqa: BLE001 — zlib/zstd errors vary
            raise ValueError(f"undecodable ICTW payload: {exc}") from None
    elif payload.startswith(_ZIP_MAGIC):
        try:
            with np.load(io.BytesIO(payload), allow_pickle=False) as z:
                out = {name: np.asarray(z[name]) for name in z.files}
        except Exception as exc:  # noqa: BLE001 — zipfile/format errors vary
            raise ValueError(f"undecodable block payload: {exc}") from None
    else:
        raise ValueError("unrecognized block payload (neither ICTW nor NPZ)")
    with _stats_lock:
        _STATS["decoded"] += 1
        _STATS["wire_bytes_in"] += len(payload)
        _STATS["raw_bytes_out"] += sum(a.nbytes for a in out.values())
    return out
