"""msac range decoder + CDF context unit tests.

Runs each check against both implementations (native C core and the
pure-Python reference) and asserts they agree symbol-for-symbol.
"""

import random

import numpy as np
import pytest

from rav1d_jax.entropy.cdf import CdfContext, get_qcat_idx
from rav1d_jax.entropy.msac import MsacContext, PyMsacContext

IMPLS = [MsacContext]
if MsacContext is not PyMsacContext:
    IMPLS.append(PyMsacContext)


def _cdf():
    return np.array([28672, 21504, 13440, 0, 0], dtype=np.uint16)


@pytest.mark.parametrize("impl", IMPLS)
def test_msac_init_state(impl):
    s = impl(bytes([0x80] + [0] * 31))
    assert s.rng == 0x8000
    # After init+refill the window holds the first bytes xor'd in
    assert s.cnt >= 0


@pytest.mark.parametrize("impl", IMPLS)
def test_bool_equi_uniformity(impl):
    # Decoding from random bytes should give roughly balanced booleans
    random.seed(7)
    data = bytes(random.randrange(256) for _ in range(4096))
    s = impl(data)
    ones = sum(s.decode_bool_equi() for _ in range(10000))
    assert 4500 < ones < 5500


@pytest.mark.parametrize("impl", IMPLS)
def test_symbol_adapt_updates_cdf(impl):
    s = impl(bytes(range(1, 65)))
    cdf = _cdf()
    before = cdf.copy()
    for _ in range(10):
        v = s.decode_symbol_adapt(cdf, 3)
        assert 0 <= v <= 3
    assert cdf[3] == 10  # counter at slot n_symbols, counts up to 32
    assert not np.array_equal(cdf[:3], before[:3])  # probabilities adapted


@pytest.mark.parametrize("impl", IMPLS)
def test_symbol_no_update_when_disabled(impl):
    s = impl(bytes(range(1, 65)), disable_cdf_update=True)
    cdf = _cdf()
    before = cdf.copy()
    for _ in range(10):
        s.decode_symbol_adapt(cdf, 3)
    assert np.array_equal(cdf, before)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_matches_reference_convention(impl):
    # rng stays within [0x8000, 0xFFFF] after each norm
    random.seed(3)
    data = bytes(random.randrange(256) for _ in range(1024))
    s = impl(data)
    cdf = _cdf()
    for _ in range(500):
        s.decode_symbol_adapt(cdf, 3)
        assert 0x8000 <= s.rng <= 0xFFFF
        s.decode_bool(20000)
        assert 0x8000 <= s.rng <= 0xFFFF


@pytest.mark.skipif(MsacContext is PyMsacContext, reason="no native core")
def test_native_matches_python_reference():
    """Symbol-for-symbol parity between the C core and the Python anchor
    across every primitive, including cdf adaptation state."""
    random.seed(11)
    data = bytes(random.randrange(256) for _ in range(8192))
    a = MsacContext(data)
    b = PyMsacContext(data)
    cdf_a, cdf_b = _cdf(), _cdf()
    bool_a = np.array([16384, 0], dtype=np.uint16)
    bool_b = bool_a.copy()
    hi_a = np.array([25000, 18000, 9000, 0, 0], dtype=np.uint16)
    hi_b = hi_a.copy()
    for i in range(2000):
        assert a.decode_symbol_adapt(cdf_a, 3) == b.decode_symbol_adapt(cdf_b, 3)
        assert a.decode_bool_adapt(bool_a) == b.decode_bool_adapt(bool_b)
        assert a.decode_bool_equi() == b.decode_bool_equi()
        assert a.decode_bool(17000) == b.decode_bool(17000)
        assert a.decode_hi_tok(hi_a) == b.decode_hi_tok(hi_b)
        assert a.decode_bools(3) == b.decode_bools(3)
        assert a.decode_uniform(11) == b.decode_uniform(11)
        assert a.decode_subexp(5, 64, 3) == b.decode_subexp(5, 64, 3)
        assert (a.rng, a.cnt, a.dif) == (b.rng, b.cnt, b.dif), i
        assert np.array_equal(cdf_a, cdf_b)
        assert np.array_equal(bool_a, bool_b)
        assert np.array_equal(hi_a, hi_b)


def test_qcat():
    assert get_qcat_idx(0) == 0
    assert get_qcat_idx(21) == 1
    assert get_qcat_idx(61) == 2
    assert get_qcat_idx(121) == 3


def test_cdf_update_zeroes_counters():
    from rav1d_jax.headers import FrameHeader, FrameType

    c = CdfContext.from_qindex(50)
    s = MsacContext(bytes(range(1, 129)))
    for _ in range(20):
        s.decode_symbol_adapt(c.m.y_mode[0], 12)
    assert c.m.y_mode[0][12] == 20
    hdr = FrameHeader()
    hdr.frame_type = FrameType.INTER
    in_cdf = CdfContext.from_qindex(50)
    u = c.updated(hdr, in_cdf)
    assert u.m.y_mode[0][12] == 0
    assert np.array_equal(u.m.y_mode[0][:12], c.m.y_mode[0][:12])
    # original untouched
    assert c.m.y_mode[0][12] == 20
    # unlisted tables (kfym) revert to the input cdf, not the tile state
    assert np.array_equal(u.kfym, in_cdf.kfym)
