"""The port's wire codec and session block format against the JAX package's.

``iterative_cleaner_tpu_torch.ingest.codec`` and ``online.blocks`` are
copies: the same arrays must encode to the same bytes, each package must
decode the other's payloads (NaN and inf bit patterns included, and the
legacy NPZ container), and the raw-byte caps must hold while decoding.
zlib is the floor both machines have; zstd is tested where
``zstandard`` imports.
"""

from __future__ import annotations

import io
import json
import struct
import zlib

import numpy as np
import pytest

from iterative_cleaner_tpu.ingest import codec as jax_codec
from iterative_cleaner_tpu.online import blocks as jax_blocks
from iterative_cleaner_tpu_torch.ingest import codec
from iterative_cleaner_tpu_torch.online import blocks

CODECS = ["shuffle-zlib", "shuffle-zstd", "npz"]


def _need(name):
    if name == "shuffle-zstd" and codec._zstd is None:
        pytest.skip("zstandard is not importable here")


def _arrays(seed=0, nsub=4, npol=2, nchan=16, nbin=64, specials=False):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(nsub, npol, nchan, nbin)).astype(np.float32)
    weights = (0.8 + 0.4 * rng.random((nsub, nchan))).astype(np.float32)
    if specials:
        bits = data.view(np.uint32).reshape(-1)
        # quiet and signalling NaNs with payloads, both infinities, -0.0
        bits[:6] = [0x7FC00001, 0x7FA00000, 0xFFC12345, 0x7F800000, 0xFF800000, 0x80000000]
        weights[0, :3] = [np.nan, np.inf, -np.inf]
    return data, weights


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


class TestEncode:
    @pytest.mark.parametrize("name", ["shuffle-zlib", "shuffle-zstd"])
    @pytest.mark.parametrize("specials", [False, True])
    def test_same_bytes_as_jax(self, name, specials):
        _need(name)
        data, weights = _arrays(specials=specials)
        arrays = {"data": data, "weights": weights}
        assert codec.encode_arrays(arrays, codec=name) == \
            jax_codec.encode_arrays(arrays, codec=name)
        assert blocks.encode_block(data, weights, codec=name) == \
            jax_blocks.encode_block(data, weights, codec=name)

    def test_default_codec_matches_jax(self, monkeypatch):
        for env in ("", "npz", "shuffle-zlib", "shuffle-zstd", "bogus"):
            monkeypatch.setenv("ICT_WIRE_CODEC", env)
            assert codec.wire_codec_name() == jax_codec.wire_codec_name()

    def test_unknown_codec_refused(self):
        with pytest.raises(ValueError, match="unknown wire codec"):
            codec.encode_arrays({"a": np.zeros(3, np.float32)}, codec="lz4")


class TestCrossDecode:
    @pytest.mark.parametrize("name", CODECS)
    @pytest.mark.parametrize("specials", [False, True])
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_each_decodes_the_other(self, name, specials, writer):
        _need(name)
        data, weights = _arrays(seed=1, specials=specials)
        enc = (blocks if writer == "port" else jax_blocks).encode_block(
            data, weights, codec=name)
        for dec in (blocks.decode_block, jax_blocks.decode_block):
            d, w = dec(enc)
            assert _same(d, data) and _same(w, weights)

    def test_legacy_npz_container(self):
        data, weights = _arrays(seed=2, specials=True)
        buf = io.BytesIO()
        np.savez(buf, data=data, weights=weights)   # an older client's upload
        d, w = blocks.decode_block(buf.getvalue())
        assert _same(d, data) and _same(w, weights)

    def test_stats_count_both_directions(self):
        codec.reset_stats()
        data, weights = _arrays()
        enc = blocks.encode_block(data, weights, codec="shuffle-zlib")
        blocks.decode_block(enc)
        s = codec.stats_snapshot()
        assert (s["encoded"], s["decoded"]) == (1, 1)
        assert s["raw_bytes_in"] == s["raw_bytes_out"] == data.nbytes + weights.nbytes
        assert s["wire_bytes_out"] == s["wire_bytes_in"] == len(enc)


def _ictw(entries, streams, codec_name="shuffle-zlib"):
    head = json.dumps({"codec": codec_name, "arrays": entries}).encode()
    return codec.MAGIC + struct.pack("<I", len(head)) + head + b"".join(streams)


class TestCaps:
    def test_header_declaring_too_many_raw_bytes(self):
        payload = _ictw([{"name": "data", "shape": [1 << 20, 1024], "dtype": "float32",
                          "nbytes": 4}], [b"\x00" * 4])
        with pytest.raises(ValueError, match="raw bytes"):
            blocks.decode_block(payload)
        with pytest.raises(ValueError, match="raw bytes"):
            codec.decode_payload(payload, max_raw_bytes=1024)

    def test_stream_inflating_past_its_declared_size(self):
        bomb = zlib.compress(b"\x00" * 4096)
        payload = _ictw([{"name": "data", "shape": [16], "dtype": "float32",
                          "nbytes": len(bomb)}], [bomb])
        with pytest.raises(ValueError, match="inflates past"):
            codec.decode_payload(payload)

    def test_block_wire_cap_matches_jax(self):
        assert blocks.MAX_BLOCK_BYTES == jax_blocks.MAX_BLOCK_BYTES
        assert blocks.MAX_RAW_BLOCK_BYTES == jax_blocks.MAX_RAW_BLOCK_BYTES

    @pytest.mark.parametrize("payload, match", [
        (b"garbage", "unrecognized"),
        (codec.MAGIC + b"\x01", "truncated"),
        (codec.MAGIC + struct.pack("<I", 100) + b"{}", "truncated"),
        (codec.MAGIC + struct.pack("<I", 2) + b"{}", "malformed"),
        (b"PK\x03\x04garbage", "undecodable"),
    ])
    def test_malformed_payloads_raise_value_error(self, payload, match):
        with pytest.raises(ValueError, match=match):
            codec.decode_payload(payload)

    def test_missing_array_is_a_value_error(self):
        enc = codec.encode_arrays({"data": np.zeros((1, 1, 2, 4), np.float32)},
                                  codec="shuffle-zlib")
        with pytest.raises(ValueError, match="missing array"):
            blocks.decode_block(enc)
