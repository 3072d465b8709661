"""Frame-ring invariance: decoding with the dense pass pipelined behind
the syntax plane (n_fc >= 2, --framedelay N) must produce bit-identical
output to the synchronous path for any delay.

Reference oracle: dav1d's thread-count invariance gate (tests/dav1d/
test.sh:63-67 runs every vector at multiple thread configs and diffs
MD5s); here the axis is frames in flight (src/internal.rs:159)."""

import hashlib

import pytest

from rav1d_jax.decoder import Decoder, EAgain, Settings
from rav1d_jax.io.ivf import IvfDemuxer

from conftest import gen_stream

INTER = dict(seed=627, width=160, height=96, frames=12)


def _md5(delay, limit=12):
    dec = Decoder(Settings(apply_grain=False, max_frame_delay=delay))
    md5 = hashlib.md5()
    n = 0
    for pkt in IvfDemuxer(gen_stream(**INTER)):
        dec.send_data(pkt.data, pkt.timestamp)
        while n < limit:
            try:
                pic = dec.get_picture()
            except EAgain:
                break
            for chunk in pic.iter_plane_rows():
                md5.update(chunk)
            n += 1
        if n >= limit:
            break
    dec.close()
    return md5.hexdigest(), n


@pytest.mark.parametrize("delay", [2, 3, 8])
def test_framedelay_invariant(delay):
    base, n0 = _md5(1)
    got, n1 = _md5(delay)
    assert n1 == n0
    assert got == base, f"framedelay={delay} changed output"


def test_flush_waits_ring():
    """flush() while dense work is in flight must not corrupt or deadlock."""
    dec = Decoder(Settings(apply_grain=False, max_frame_delay=4))
    it = iter(IvfDemuxer(gen_stream(**INTER)))
    for _ in range(3):
        dec.send_data(next(it).data, 0)
        try:
            dec.get_picture()
        except EAgain:
            pass
    dec.flush()
    # decoder still usable from a keyframe
    md5, n = _md5(2, limit=4)
    assert n == 4
