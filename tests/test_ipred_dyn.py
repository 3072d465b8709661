"""Randomized parity: traced-size intra kernels (ops/dev/ipred_dyn) vs the
scalar reference (ops/ref/ipred) — the checkasm pattern
(dav1d tests/checkasm/ipred.c) at class granularity: one batch
mixes many (w, h) sizes and angles, every item must match bit-exactly."""

import numpy as np
import pytest

from rav1d_jax.ops.ref import ipred as R
from rav1d_jax.ops.dev import ipred_dyn as D
from rav1d_jax.syntax.levels import (
    DC_128_PRED,
    DC_PRED,
    HOR_PRED,
    LEFT_DC_PRED,
    PAETH_PRED,
    SMOOTH_H_PRED,
    SMOOTH_PRED,
    SMOOTH_V_PRED,
    TOP_DC_PRED,
    VERT_PRED,
    Z1_PRED,
    Z2_PRED,
    Z3_PRED,
)

RNG = np.random.default_rng(0x1BBED)

REF_FNS = {
    DC_PRED: R.ipred_dc,
    VERT_PRED: R.ipred_v,
    HOR_PRED: R.ipred_h,
    LEFT_DC_PRED: R.ipred_dc_left,
    TOP_DC_PRED: R.ipred_dc_top,
    DC_128_PRED: R.ipred_dc_128,
    SMOOTH_PRED: R.ipred_smooth,
    SMOOTH_V_PRED: R.ipred_smooth_v,
    SMOOTH_H_PRED: R.ipred_smooth_h,
    PAETH_PRED: R.ipred_paeth,
}

DYN_FNS = {
    DC_PRED: D.dc_dyn,
    VERT_PRED: D.v_dyn,
    HOR_PRED: D.h_dyn,
    LEFT_DC_PRED: D.dc_left_dyn,
    TOP_DC_PRED: D.dc_top_dyn,
    DC_128_PRED: D.dc_128_dyn,
    SMOOTH_PRED: D.smooth_dyn,
    SMOOTH_V_PRED: D.smooth_v_dyn,
    SMOOTH_H_PRED: D.smooth_h_dyn,
    PAETH_PRED: D.paeth_dyn,
}


def _sizes_for_class(CW, CH):
    out = []
    for w in (4, 8, 16, 32, 64):
        for h in (4, 8, 16, 32, 64):
            if w <= CW and h <= CH and max(w, h) <= 4 * min(w, h):
                out.append((w, h))
    return out


def _ref_edge_from_class(edge_row, C):
    """Re-centre a class-layout edge row at ref offset 128."""
    tl = np.zeros(257, np.int32)
    n_left = C
    n_top = len(edge_row) - C - 1
    tl[128 - n_left : 128 + 1 + n_top] = edge_row
    return tl, 128


@pytest.mark.parametrize("CW,CH", [(16, 16), (64, 64)])
@pytest.mark.parametrize("bpc", [8, 10])
def test_base_modes_dyn(CW, CH, bpc):
    import jax.numpy as jnp

    C = 2 * CH
    EL = 2 * CH + 1 + 2 * CW
    sizes = _sizes_for_class(CW, CH)
    for mode, dyn in DYN_FNS.items():
        B = len(sizes)
        edge = RNG.integers(0, 1 << bpc, (B, EL)).astype(np.int32)
        w = np.array([s[0] for s in sizes], np.int32)
        h = np.array([s[1] for s in sizes], np.int32)
        got = np.asarray(dyn(jnp.asarray(edge), C, CW, CH,
                             jnp.asarray(w), jnp.asarray(h), bpc))
        for k, (ww, hh) in enumerate(sizes):
            dst = np.zeros((hh, ww), np.int32)
            tl, off = _ref_edge_from_class(edge[k], C)
            REF_FNS[mode](dst, tl, off, ww, hh, 0, 0, 0, bpc)
            assert (got[k, :hh, :ww] == dst).all(), (mode, ww, hh)


@pytest.mark.parametrize("CW,CH", [(16, 16), (64, 64)])
@pytest.mark.parametrize("bpc", [8, 10])
@pytest.mark.parametrize("zmode", [Z1_PRED, Z2_PRED, Z3_PRED])
def test_z_modes_dyn(CW, CH, bpc, zmode):
    import jax.numpy as jnp

    C = 2 * CH
    EL = 2 * CH + 1 + 2 * CW
    cases = []
    for (ww, hh) in _sizes_for_class(CW, CH):
        for _ in range(3):
            # real mode-derived angles only: base + 3*delta, delta in [-3, 3]
            # (other angles hit placeholder zeros in dr_intra_derivative)
            bases = [90, 180, 45, 135, 113, 157, 203, 67]
            while True:
                angle = int(RNG.choice(bases)) + 3 * int(RNG.integers(-3, 4))
                if zmode == Z1_PRED and angle < 90:
                    break
                if zmode == Z2_PRED and 90 < angle < 180:
                    break
                if zmode == Z3_PRED and angle > 180:
                    break
            sm = int(RNG.integers(0, 2))
            ief = int(RNG.integers(0, 2))
            cases.append((ww, hh, angle | (sm << 9) | (ief << 10)))
    B = len(cases)
    edge = RNG.integers(0, 1 << bpc, (B, EL)).astype(np.int32)
    w = np.array([c[0] for c in cases], np.int32)
    h = np.array([c[1] for c in cases], np.int32)
    ang = np.array([c[2] for c in cases], np.int32)
    mw = np.array([c[0] for c in cases], np.int32)  # max_w = w
    mh = np.array([c[1] for c in cases], np.int32)
    if zmode == Z1_PRED:
        got = np.asarray(D.z1_dyn(jnp.asarray(edge), C, CW, CH,
                                  jnp.asarray(w), jnp.asarray(h), bpc,
                                  jnp.asarray(ang)))
        ref_fn = R.ipred_z1
    elif zmode == Z2_PRED:
        got = np.asarray(D.z2_dyn(jnp.asarray(edge), C, CW, CH,
                                  jnp.asarray(w), jnp.asarray(h), bpc,
                                  jnp.asarray(ang), jnp.asarray(mw),
                                  jnp.asarray(mh),
                                  jnp.zeros(B, bool)))
        ref_fn = R.ipred_z2
    else:
        got = np.asarray(D.z3_dyn(jnp.asarray(edge), C, CW, CH,
                                  jnp.asarray(w), jnp.asarray(h), bpc,
                                  jnp.asarray(ang)))
        ref_fn = R.ipred_z3
    for k, (ww, hh, packed) in enumerate(cases):
        dst = np.zeros((hh, ww), np.int32)
        tl, off = _ref_edge_from_class(edge[k], C)
        ref_fn(dst, tl, off, ww, hh, packed, ww, hh, bpc)
        assert (got[k, :hh, :ww] == dst).all(), (zmode, ww, hh, packed & 511)


@pytest.mark.parametrize("CW,CH", [(16, 16), (32, 32)])
def test_filter_dyn(CW, CH):
    import jax.numpy as jnp

    bpc = 8
    C = 2 * CH
    EL = 2 * CH + 1 + 2 * CW
    cases = [(w, h, int(RNG.integers(0, 5)))
             for w in (4, 8, 16) for h in (4, 8, 16)
             if w <= CW and h <= CH]
    B = len(cases)
    edge = RNG.integers(0, 256, (B, EL)).astype(np.int32)
    w = np.array([c[0] for c in cases], np.int32)
    h = np.array([c[1] for c in cases], np.int32)
    fi = np.array([c[2] for c in cases], np.int32)
    got = np.asarray(D.filter_dyn(jnp.asarray(edge), C, CW, CH,
                                  jnp.asarray(w), jnp.asarray(h), bpc,
                                  jnp.asarray(fi)))
    for k, (ww, hh, f) in enumerate(cases):
        dst = np.zeros((hh, ww), np.int32)
        tl, off = _ref_edge_from_class(edge[k], C)
        R.ipred_filter(dst, tl, off, ww, hh, f, 0, 0, bpc)
        assert (got[k, :hh, :ww] == dst).all(), (ww, hh, f)


@pytest.mark.parametrize("ss_hor,ss_ver", [(1, 1), (1, 0), (0, 0)])
def test_cfl_ac_dyn(ss_hor, ss_ver):
    import jax.numpy as jnp

    CW = CH = 16
    cases = []
    for w in (4, 8, 16):
        for h in (4, 8, 16):
            wp = int(RNG.integers(0, max(w // 4 - 1, 1)))
            hp = int(RNG.integers(0, max(h // 4 - 1, 1)))
            cases.append((w, h, wp, hp))
    B = len(cases)
    ypx = RNG.integers(0, 256, (B, CH << ss_ver, CW << ss_hor)).astype(np.int32)
    w = np.array([c[0] for c in cases], np.int32)
    h = np.array([c[1] for c in cases], np.int32)
    wp = np.array([c[2] for c in cases], np.int32)
    hp = np.array([c[3] for c in cases], np.int32)
    got = np.asarray(D.cfl_ac_dyn(jnp.asarray(ypx), CW, CH,
                                  jnp.asarray(w), jnp.asarray(h),
                                  ss_hor, ss_ver,
                                  jnp.asarray(wp), jnp.asarray(hp)))
    for k, (ww, hh, wpad, hpad) in enumerate(cases):
        ac = np.zeros((hh, ww), np.int64)
        R.cfl_ac(ac, ypx[k], wpad, hpad, ww, hh, ss_hor, ss_ver)
        assert (got[k, :hh, :ww] == ac).all(), (ww, hh, wpad, hpad)
