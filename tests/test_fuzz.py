"""Corrupt-stream fuzzing: the decoder must never crash, hang, or wedge on
malformed input — it raises DecodeError/EAgain, poisons the bad temporal
unit, and keeps decoding later valid data.

Reference contract: tests/libfuzzer/dav1d_fuzzer.c:40-50 (any byte stream
is safe to feed) and src/lib.rs cached-error semantics (a decode error is
returned once, the context stays alive). The mutation corpus here is
deterministic (seeded): bit flips, truncations, and garbage injections over
generated streams (rav1d_jax/gen).
"""

import numpy as np
import pytest

from rav1d_jax.decoder import DecodeError, Decoder, EAgain, Settings
from rav1d_jax.io.ivf import IvfDemuxer

from conftest import gen_stream

VEC_INTRA = dict(seed=0, width=128, height=96, frames=6, kf_every=1)
VEC_INTER = dict(seed=627, width=160, height=96, frames=12)

ACCEPTABLE = (DecodeError, EAgain)


def _packets(spec, limit=6):
    pkts = []
    for pkt in IvfDemuxer(gen_stream(**spec)):
        pkts.append(bytes(pkt.data))
        if len(pkts) >= limit:
            break
    return pkts


def _feed(dec, data):
    """Feed one TU and drain; only ACCEPTABLE exceptions may escape."""
    got = 0
    try:
        dec.send_data(data, 0)
    except ACCEPTABLE:
        return got
    while True:
        try:
            dec.get_picture()
            got += 1
        except EAgain:
            break
        except DecodeError:
            break
    return got


@pytest.mark.parametrize("vec", [VEC_INTRA, VEC_INTER], ids=["intra", "inter"])
def test_bitflip_fuzz(vec):
    pkts = _packets(vec)
    rng = np.random.default_rng(0xC0FFEE)
    for trial in range(40):
        dec = Decoder(Settings(apply_grain=False))
        for i, p in enumerate(pkts):
            buf = bytearray(p)
            # flip 1-8 bits at random positions in one random packet
            if i == trial % len(pkts):
                for _ in range(int(rng.integers(1, 9))):
                    pos = int(rng.integers(0, len(buf)))
                    buf[pos] ^= 1 << int(rng.integers(0, 8))
            _feed(dec, bytes(buf))


@pytest.mark.parametrize("vec", [VEC_INTRA, VEC_INTER], ids=["intra", "inter"])
def test_truncation_fuzz(vec):
    pkts = _packets(vec)
    rng = np.random.default_rng(0xF00D)
    for trial in range(25):
        dec = Decoder(Settings(apply_grain=False))
        for i, p in enumerate(pkts):
            buf = p
            if i == trial % len(pkts) and len(p) > 2:
                cut = int(rng.integers(1, len(p)))
                buf = p[:cut]
            _feed(dec, buf)


def test_garbage_streams():
    rng = np.random.default_rng(1234)
    dec = Decoder(Settings(apply_grain=False))
    for _ in range(30):
        blob = rng.integers(0, 256, int(rng.integers(1, 4096))).astype(
            np.uint8
        ).tobytes()
        _feed(dec, blob)


def test_decoder_survives_poison_then_decodes():
    """After a poisoned TU, the same Decoder must still decode a fresh
    valid stream from its keyframe (dav1d poison-not-kill)."""
    pkts = _packets(VEC_INTER, limit=4)
    dec = Decoder(Settings(apply_grain=False))
    # poison: feed garbage, then a corrupted keyframe
    _feed(dec, b"\x12\x00garbage-not-an-obu" * 8)
    bad = bytearray(pkts[0])
    for pos in range(0, len(bad), 97):
        bad[pos] ^= 0xFF
    _feed(dec, bytes(bad))
    # now the pristine stream must decode
    got = 0
    for p in pkts:
        got += _feed(dec, p)
    assert got >= 1, "decoder wedged after poisoned input"
