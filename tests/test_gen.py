"""The seeded stream generator (rav1d_jax/gen): range coder round trips,
header round trips through obu.py, determinism, and the generated streams
decoding identically on the native syntax pass and the Python anchor."""

import contextlib
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from rav1d_jax.entropy.cdf import CdfContext
from rav1d_jax.entropy.msac import NativeMsacContext, PyMsacContext
from rav1d_jax.gen import headers as W
from rav1d_jax.gen.msac import MsacEncoder, SymbolChooser
from rav1d_jax.gen.stream import StreamSpec, frame_headers, generate

# one op = (primitive, argument); arguments index fixed CDF rows so the
# decoder side can replay them against its own adapted copy
_OPS = st.one_of(
    st.tuples(st.just("equi"), st.just(0)),
    st.tuples(st.just("bool"), st.integers(1, 32767)),
    st.tuples(st.just("bool_adapt"), st.integers(0, 2)),
    st.tuples(st.just("symbol"), st.integers(0, 15)),
    st.tuples(st.just("hi_tok"), st.integers(0, 3)),
    st.tuples(st.just("bools"), st.integers(1, 16)),
    st.tuples(st.just("uniform"), st.integers(2, 1000)),
    st.tuples(st.just("subexp"), st.integers(0, 63)),
)


def _apply(m, cdf, op, arg):
    if op == "equi":
        return m.decode_bool_equi()
    if op == "bool":
        return m.decode_bool(arg)
    if op == "bool_adapt":
        return m.decode_bool_adapt(cdf.m.skip[arg])
    if op == "symbol":  # partition rows: 8x8 (3) and larger (9) levels
        bl, ctx = (4, arg & 3) if arg < 4 else (1 + (arg & 3) % 3, arg >> 2)
        n = 3 if bl == 4 else 9
        return m.decode_symbol_adapt(cdf.m.partition[bl][ctx], n)
    if op == "hi_tok":
        return m.decode_hi_tok(cdf.coef.br_tok[0][0][arg])
    if op == "bools":
        return m.decode_bools(arg)
    if op == "uniform":
        return m.decode_uniform(arg)
    return m.decode_subexp(arg, 64, 3)


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(_OPS, min_size=1, max_size=400),
       seed=st.integers(0, 2**32 - 1), disable=st.booleans())
def test_msac_encoder_round_trip(ops, seed, disable):
    """Every primitive the chooser picks decodes back to the same value on
    the Python and the native msac decoders."""
    ch = SymbolChooser(np.random.default_rng(seed), disable)
    cdf = CdfContext.from_qindex(100)
    chosen = [_apply(ch, cdf, op, arg) for op, arg in ops]
    data = MsacEncoder().encode_all(ch.record)
    for cls in (PyMsacContext, NativeMsacContext):
        dec = cls(data, disable)
        cdf2 = CdfContext.from_qindex(100)
        got = [_apply(dec, cdf2, op, arg) for op, arg in ops]
        assert got == chosen, cls.__name__
        assert dec.cnt >= -15  # the decoder's overread guard holds


def test_chooser_follows_the_cdf():
    """An adaptive symbol is drawn from the CDF it is given (no adaptation,
    so the distribution stays put)."""
    ch = SymbolChooser(np.random.default_rng(0), disable_cdf_update=True)
    row = CdfContext.from_qindex(100).m.partition[1][0]
    icdf = np.append(row[:9].astype(np.int64), 0)
    want = -np.diff(np.concatenate([[32768], icdf])) / 32768
    counts = np.bincount([ch.decode_symbol_adapt(row, 9) for _ in range(20000)],
                         minlength=10)
    np.testing.assert_allclose(counts / 20000, want, atol=0.015)


def _parse_seq(data):
    """Parse a sequence header OBU into a fresh decoder."""
    from rav1d_jax import obu
    from rav1d_jax.decoder import Decoder

    dec = Decoder()
    obu.parse_obus(dec, data)
    return dec.seq_hdr


@pytest.mark.parametrize("spec", [
    StreamSpec(seed=3, width=352, height=288, bpc=8, frames=1),
    StreamSpec(seed=4, width=1920, height=1080, bpc=10, frames=1),
    StreamSpec(seed=5, width=640, height=360, bpc=8, frames=1, tiles=(2, 2)),
])
def test_seq_header_round_trip(spec):
    seq, _ = frame_headers(spec)
    assert _parse_seq(W.seq_obu(seq)) == seq


@pytest.mark.parametrize("spec", [
    StreamSpec(seed=6, width=208, height=144, bpc=8, frames=4),
    StreamSpec(seed=7, width=256, height=192, bpc=10, frames=3, kf_every=2),
    StreamSpec(seed=8, width=640, height=360, bpc=8, frames=2, tiles=(2, 2)),
])
def test_frame_header_round_trip(spec):
    """The headers written for a stream parse back (through obu.py, with
    the references the stream builds up) to the values the generator set."""
    from rav1d_jax.decoder import Decoder
    from rav1d_jax.io.ivf import IvfDemuxer
    from rav1d_jax.native import syntax as nsy

    seq, want = frame_headers(spec)
    dec = Decoder()
    got = []
    submit = dec.submit_frame

    def capture():
        got.append(dec.frame_hdr)
        submit()

    dec.submit_frame = capture
    for pkt in IvfDemuxer(generate(spec)):
        dec.send_data(pkt.data)
        with contextlib.suppress(Exception):
            dec.get_picture()
    assert nsy.enabled()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("frame_type", "show_frame", "frame_offset",
                     "primary_ref_frame", "refresh_frame_flags", "refidx",
                     "hp", "subpel_filter_mode", "switchable_motion_mode",
                     "use_ref_frame_mvs", "refresh_context", "quant",
                     "loopfilter", "txfm_mode", "switchable_comp_refs",
                     "warp_motion", "reduced_txtp_set", "gmv"):
            assert getattr(g, name) == getattr(w, name), name
        assert g.size.width == w.size.width and g.size.height == w.size.height
        assert (g.tiling.cols, g.tiling.rows, g.tiling.update) == (
            spec.tiles[0], spec.tiles[1], w.tiling.update)
        assert g.cdef.damping == w.cdef.damping
        n = 1 << g.cdef.n_bits
        assert g.cdef.y_strength[:n] == w.cdef.y_strength[:n]
        assert g.cdef.uv_strength[:n] == w.cdef.uv_strength[:n]
        assert tuple(g.restoration.type) == tuple(w.restoration.type)
        assert tuple(g.restoration.unit_size) == tuple(w.restoration.unit_size)


def test_header_writer_rejects_unsupported_options():
    seq, fhs = frame_headers(StreamSpec(seed=1, width=64, height=64, frames=1))
    with pytest.raises(ValueError):
        W.write_seq_hdr(W.PutBits(), dataclasses.replace(seq, super_res=1))
    fh = fhs[0]
    fh.segmentation.enabled = 1
    with pytest.raises(ValueError):
        W.write_frame_hdr(W.PutBits(), seq, fh, False)


def test_generation_is_deterministic():
    spec = StreamSpec(seed=21, width=128, height=96, frames=3)
    a = generate(spec)
    assert generate(spec) == a
    assert generate(dataclasses.replace(spec, seed=22)) != a


@pytest.mark.parametrize("spec", [
    StreamSpec(seed=31, width=320, height=240, bpc=8, frames=2),
    StreamSpec(seed=32, width=192, height=128, bpc=10, frames=2),
    StreamSpec(seed=33, width=512, height=256, bpc=8, frames=2, tiles=(2, 2)),
])
def test_native_syntax_matches_anchor(spec):
    """The C syntax pass and the Python anchor produce the same work items,
    coefficients and per-frame syntax products on a generated stream
    (tools_py/dual_check.py)."""
    from tools_py.dual_check import first_divergence, work_item_rows

    data = generate(spec)
    native = work_item_rows(data, native=True)
    anchor = work_item_rows(data, native=False)
    assert not any(r[0] == "EXC" for r in native), native[-1]
    assert sum(r[0] == "STATE" for r in native) == spec.frames
    assert first_divergence(native, anchor) is None
