"""OBU / header parsing tests on generated streams."""

import pytest

from conftest import gen_stream
from rav1d_jax.io.ivf import IvfDemuxer
from rav1d_jax.decoder import Decoder
from rav1d_jax.headers import FrameType, PixelLayout, Profile


class _Stop(Exception):
    pass


def parse_first_tu(path):
    """Feed the first temporal unit, stopping at frame submission (headers
    fully parsed; decode itself is covered by the e2e tests)."""
    demux = IvfDemuxer(path)
    dec = Decoder()

    def stop():
        dec.submitted_hdr = dec.frame_hdr
        raise _Stop

    dec.submit_frame = stop
    pkt = demux.read()
    try:
        dec.send_data(pkt.data, pkt.timestamp)
    except (_Stop, NotImplementedError):
        pass
    except Exception as e:
        # send_data wraps everything in DecodeError (poison-not-kill
        # contract); unwrap to find our stop sentinel
        causes = []
        c = e
        while c is not None:
            causes.append(type(c))
            c = c.__cause__
        if _Stop not in causes and NotImplementedError not in causes:
            raise
    return dec, demux


def test_seq_hdr_16x16():
    dec, demux = parse_first_tu(gen_stream(seed=16, width=16, height=16, frames=1))
    sh = dec.seq_hdr
    assert sh is not None
    assert sh.profile == Profile.MAIN
    assert (sh.max_width, sh.max_height) == (16, 16)
    assert sh.layout == PixelLayout.I420
    assert sh.hbd == 0
    assert (demux.width, demux.height) == (16, 16)


def test_seq_hdr_allintra():
    dec, _ = parse_first_tu(gen_stream(seed=2, width=352, height=288, frames=1))
    sh = dec.seq_hdr
    assert (sh.max_width, sh.max_height) == (352, 288)
    assert sh.layout == PixelLayout.I420


def test_seq_hdr_10bit():
    dec, _ = parse_first_tu(gen_stream(seed=10, width=64, height=48, bpc=10, frames=1))
    assert dec.seq_hdr.hbd >= 1


@pytest.mark.parametrize("size", [(16, 16), (66, 34), (128, 96), (352, 288),
                                  (720, 480), (1280, 720)])
def test_all_8bit_headers_parse(size):
    """The first temporal unit of generated streams of many sizes parses to
    the size and frame type that were written."""
    w, h = size
    dec, demux = parse_first_tu(gen_stream(seed=w * h, width=w, height=h,
                                           frames=1))
    assert (dec.seq_hdr.max_width, dec.seq_hdr.max_height) == (w, h)
    fh = dec.submitted_hdr
    assert fh.frame_type == FrameType.KEY
    assert fh.size.width == (w, w) and fh.size.height == h
