"""Cross-check the native refmvs core against the Python anchor.

checkasm-style parity (tests/checkasm/refmvs.c analog): every refmvs_find
call during a real decode runs both the C core and the Python reference and
must produce identical (mvstack, cnt, ctx).
"""

import pytest

from conftest import gen_stream
from rav1d_jax.syntax import refmvs as R


@pytest.fixture
def crosscheck(monkeypatch):
    if R.refmvs_find.__module__ is None:  # pragma: no cover
        pytest.skip("no native core")
    from rav1d_jax.native import LIB_REFMVS

    if LIB_REFMVS is None:
        pytest.skip("native refmvs unavailable")

    calls = {"n": 0}

    def checked(rt, rf, ref_pair, bs, edge_flags, by4, bx4, frame_hdr):
        got = R.refmvs_find_native(rt, rf, ref_pair, bs, edge_flags, by4, bx4, frame_hdr)
        want = R.refmvs_find_py(rt, rf, ref_pair, bs, edge_flags, by4, bx4, frame_hdr)
        assert got[1] == want[1], (got[1], want[1], bx4, by4, bs)
        assert got[2] == want[2], (got[2], want[2], bx4, by4, bs)
        for i in range(got[1]):
            assert got[0][i].mv == want[0][i].mv, (i, got[0][i].mv, want[0][i].mv)
            assert got[0][i].weight == want[0][i].weight
        # slots up to 2 are read for DRL even past cnt
        for i in range(got[1], 2):
            assert got[0][i].mv[0] == want[0][i].mv[0]
        calls["n"] += 1
        return want

    monkeypatch.setattr(R, "refmvs_find", checked)
    import rav1d_jax.syntax.decode as D

    monkeypatch.setattr(D.refmvs, "refmvs_find", checked)
    # the hook lives on the Python syntax pass; force it on
    from rav1d_jax.native import syntax as nsy

    monkeypatch.setattr(nsy, "FORCE_OFF", True)
    return calls


@pytest.mark.parametrize(
    "spec,frames",
    [
        (dict(seed=5, width=176, height=144, frames=6), 6),
        (dict(seed=6, width=208, height=112, frames=6), 6),
        (dict(seed=627, width=160, height=96, frames=6), 6),
    ],
)
def test_refmvs_native_parity(crosscheck, spec, frames):
    from rav1d_jax.decoder import Decoder, EAgain, Settings
    from rav1d_jax.io import probe_demuxer

    dec = Decoder(Settings(apply_grain=False))
    n = 0
    for pkt in probe_demuxer(gen_stream(**spec)):
        dec.send_data(pkt.data, pkt.timestamp)
        while True:
            try:
                dec.get_picture()
                n += 1
            except EAgain:
                break
        if n >= frames:
            break
    assert calls_ran(crosscheck)


def calls_ran(calls):
    return calls["n"] > 0
