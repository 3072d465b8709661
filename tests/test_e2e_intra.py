"""End-to-end intra decodes of generated key-frame streams: the host
decode with the native syntax pass must equal the decode with the Python
syntax anchor, pixel for pixel (the stream generator's oracle is the
decoder itself, so the anchor is the independent reference here)."""

import contextlib

import pytest

from conftest import gen_stream
from rav1d_jax.decoder import Decoder, EAgain, Settings
from rav1d_jax.io import probe_demuxer
from rav1d_jax.io.muxers import Md5Muxer


def decode_md5(path, anchor=False):
    from rav1d_jax.native import syntax as nsy

    saved, nsy.FORCE_OFF = nsy.FORCE_OFF, anchor
    try:
        dec = Decoder(Settings(apply_grain=False))
        md5 = Md5Muxer()
        n = 0
        for pkt in probe_demuxer(path):
            dec.send_data(pkt.data, pkt.timestamp)
            while True:
                try:
                    md5.write_picture(dec.get_picture())
                    n += 1
                except EAgain:
                    break
        return md5.digest(), n
    finally:
        nsy.FORCE_OFF = saved


@pytest.mark.parametrize(
    "spec",
    [
        dict(seed=324, width=208, height=144, frames=1),
        dict(seed=325, width=200, height=120, frames=1),
    ],
)
def test_intra_bit_exact(spec):
    path = gen_stream(**spec)
    got, n = decode_md5(path)
    assert n == 1
    assert (got, n) == decode_md5(path, anchor=True)


@pytest.mark.parametrize(
    "spec,frames",
    [(dict(seed=320, width=256, height=160, bpc=10, frames=2, kf_every=1), 2)],
)
def test_intra_lr_bit_exact(spec, frames):
    path = gen_stream(**spec)
    got, n = decode_md5(path)
    assert n == frames
    assert (got, n) == decode_md5(path, anchor=True)


@pytest.mark.slow
def test_allintra_bit_exact():
    path = gen_stream(seed=2, width=352, height=288, frames=8, kf_every=1)
    got, n = decode_md5(path)
    assert n == 8
    assert (got, n) == decode_md5(path, anchor=True)


@pytest.mark.slow
def test_longleb_bit_exact():
    """A 1080p key frame: tile payloads large enough for multi-byte OBU
    size fields."""
    path = gen_stream(seed=3, width=1920, height=1080, frames=1)
    with contextlib.suppress(StopIteration):
        assert len(next(iter(probe_demuxer(path))).data) > 1 << 14
    got, n = decode_md5(path)
    assert n == 1
    assert (got, n) == decode_md5(path, anchor=True)
