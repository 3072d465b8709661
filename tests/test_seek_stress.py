"""Seek/flush torture (parity: tests/seek_stress.rs behavior).

Random mid-stream flushes and re-feeding from keyframes must produce the
same pixels as a straight decode — flush() drops all buffered input,
output, and reference state (dav1d_flush, src/lib.rs:671).
"""

import random

import pytest

from conftest import gen_stream
from rav1d_jax.decoder import Decoder, EAgain, Settings
from rav1d_jax.io import probe_demuxer
from rav1d_jax.io.muxers import Md5Muxer


INTRA = dict(seed=324, width=208, height=144, frames=1)
INTER = dict(seed=627, width=160, height=96, frames=12)


def _drain(dec, sink):
    n = 0
    while True:
        try:
            sink(dec.get_picture())
            n += 1
        except EAgain:
            return n


def test_flush_then_redecode_matches():
    """Decode, flush mid-stream, re-feed from the start: the re-decode must
    be bit-identical to a fresh decode."""
    path = gen_stream(**INTRA)
    pkts = list(probe_demuxer(path))

    def full_md5():
        dec = Decoder(Settings(apply_grain=False))
        md5 = Md5Muxer()
        for p in pkts:
            dec.send_data(p.data, p.timestamp)
            _drain(dec, md5.write_picture)
        return md5.digest()

    want = full_md5()

    dec = Decoder(Settings(apply_grain=False))
    dec.send_data(pkts[0].data, pkts[0].timestamp)
    _drain(dec, lambda pic: None)
    dec.flush()
    md5 = Md5Muxer()
    for p in pkts:
        dec.send_data(p.data, p.timestamp)
        _drain(dec, md5.write_picture)
    assert md5.digest() == want


def test_random_seek_flush_stress():
    """Random flush points over a multi-frame stream; after each flush,
    re-feeding from the start must decode cleanly to the same frame count
    and MD5 (seek_stress.rs random-seek loop analog)."""
    path = gen_stream(**INTER)
    pkts = list(probe_demuxer(path))[:12]

    dec = Decoder(Settings(apply_grain=False))
    ref_md5 = Md5Muxer()
    nref = 0
    for p in pkts:
        dec.send_data(p.data, p.timestamp)
        nref += _drain(dec, ref_md5.write_picture)

    rnd = random.Random(42)
    for _trial in range(3):
        dec = Decoder(Settings(apply_grain=False))
        stop = rnd.randrange(1, len(pkts))
        for p in pkts[:stop]:
            dec.send_data(p.data, p.timestamp)
            _drain(dec, lambda pic: None)
        dec.flush()
        # seek back to the keyframe (packet 0) and decode the whole stream
        md5 = Md5Muxer()
        n = 0
        for p in pkts:
            dec.send_data(p.data, p.timestamp)
            n += _drain(dec, md5.write_picture)
        assert n == nref
        assert md5.digest() == ref_md5.digest()


def test_flush_clears_pending_eagain():
    """send_data raises EAgain while input is pending; flush must clear it."""
    path = gen_stream(**INTRA)
    pkts = list(probe_demuxer(path))
    dec = Decoder(Settings(apply_grain=False))
    dec.send_data(pkts[0].data, pkts[0].timestamp)
    dec.flush()
    # after flush the decoder accepts input again immediately
    dec.send_data(pkts[0].data, pkts[0].timestamp)
    assert _drain(dec, lambda pic: None) >= 0
