"""checkasm-style parity: device (jax) intra prediction vs numpy reference."""

import numpy as np
import pytest

from rav1d_jax.ops.ref import ipred as R

MODES = [
    ("dc", R.ipred_dc),
    ("dc_top", R.ipred_dc_top),
    ("dc_left", R.ipred_dc_left),
    ("dc_128", R.ipred_dc_128),
    ("v", R.ipred_v),
    ("h", R.ipred_h),
    ("paeth", R.ipred_paeth),
    ("smooth", R.ipred_smooth),
    ("smooth_v", R.ipred_smooth_v),
    ("smooth_h", R.ipred_smooth_h),
]


@pytest.mark.parametrize("bpc", [8, 10])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 16), (32, 8), (64, 64)])
@pytest.mark.parametrize("name", [m[0] for m in MODES])
def test_ipred_batch_parity(name, w, h, bpc):
    from rav1d_jax.ops.dev import ipred as T

    ref_fn = dict(MODES)[name]
    dev_fn = getattr(T, f"ipred_{name}_batch")
    rng = np.random.default_rng(hash((name, w, h, bpc)) & 0xFFFF)
    N = 7
    off = 2 * 64  # edge buffer center, matching ipred_prepare layout slack
    L = 2 * off + 1
    tls = rng.integers(0, (1 << bpc) - 1, (N, L)).astype(np.int32)

    want = np.zeros((N, h, w), dtype=np.int32)
    for i in range(N):
        ref_fn(want[i], tls[i], off, w, h, 0, w, h, bpc)
    got = np.asarray(dev_fn(tls, off, w, h, bpc))
    np.testing.assert_array_equal(got, want)


from rav1d_jax.ops.ref import ipred as RI


def _rand_edge(rng, n, bpc, L=257):
    return rng.integers(0, (1 << bpc) - 1, (n, L)).astype(np.int32)


# real AV1 directional angles: mode base angles +- 3*delta
# (ipred_prepare.rs mode_to_angle + angle derivation)
_BASES = [45, 67, 90, 113, 135, 157, 180, 203]
_ALL_ANGLES = sorted({b + 3 * d for b in _BASES for d in range(-3, 4)})
Z1_ANGLES = np.asarray([a for a in _ALL_ANGLES if 0 < a < 90])
Z2_ANGLES = np.asarray([a for a in _ALL_ANGLES if 90 < a < 180])
Z3_ANGLES = np.asarray([a for a in _ALL_ANGLES if 180 < a < 270])


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 4), (16, 16), (4, 16), (32, 8), (64, 64)])
def test_z1_batch_parity(bpc, w, h):
    from rav1d_jax.ops.dev.ipred import ipred_z1_batch

    rng = np.random.default_rng(bpc + w * 3 + h)
    N, off = 24, 128
    tls = _rand_edge(rng, N, bpc)
    angles = rng.choice(Z1_ANGLES, N)
    sm = rng.integers(0, 2, N)
    ief = rng.integers(0, 2, N)
    packed = (angles | (sm << 9) | (ief << 10)).astype(np.int32)

    want = np.zeros((N, h, w), np.int32)
    for i in range(N):
        RI.ipred_z1(want[i], tls[i], off, w, h, int(packed[i]), 0, 0, bpc)
    got = np.asarray(ipred_z1_batch(tls, off, w, h, bpc, angles=packed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 16), (16, 8), (32, 32), (64, 16)])
def test_z3_batch_parity(bpc, w, h):
    from rav1d_jax.ops.dev.ipred import ipred_z3_batch

    rng = np.random.default_rng(bpc + w * 5 + h)
    N, off = 24, 128
    tls = _rand_edge(rng, N, bpc)
    angles = rng.choice(Z3_ANGLES, N)
    sm = rng.integers(0, 2, N)
    ief = rng.integers(0, 2, N)
    packed = (angles | (sm << 9) | (ief << 10)).astype(np.int32)

    want = np.zeros((N, h, w), np.int32)
    for i in range(N):
        RI.ipred_z3(want[i], tls[i], off, w, h, int(packed[i]), 0, 0, bpc)
    got = np.asarray(ipred_z3_batch(tls, off, w, h, bpc, angles=packed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 16), (16, 8), (32, 32), (64, 32)])
def test_z2_batch_parity(bpc, w, h):
    from rav1d_jax.ops.dev.ipred import ipred_z2_batch

    rng = np.random.default_rng(bpc + w * 7 + h)
    N, off = 24, 128
    tls = _rand_edge(rng, N, bpc)
    angles = rng.choice(Z2_ANGLES, N)
    sm = rng.integers(0, 2, N)
    ief = rng.integers(0, 2, N)
    packed = (angles | (sm << 9) | (ief << 10)).astype(np.int32)
    max_ws = rng.integers(1, w + 1, N).astype(np.int32)
    max_hs = rng.integers(1, h + 1, N).astype(np.int32)
    smooth = rng.integers(0, 2, N).astype(bool)

    want = np.zeros((N, h, w), np.int32)
    for i in range(N):
        tl = tls[i].copy()
        if smooth[i]:
            tl[off] = ((int(tl[off - 1]) + int(tl[off + 1])) * 5
                       + int(tl[off]) * 6 + 8) >> 4
        RI.ipred_z2(want[i], tl, off, w, h, int(packed[i]),
                    int(max_ws[i]), int(max_hs[i]), bpc)
    got = np.asarray(ipred_z2_batch(tls, off, w, h, bpc, angles=packed,
                                    max_ws=max_ws, max_hs=max_hs,
                                    smooth_tl=smooth))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpc", [8, 10])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (32, 16), (16, 32)])
def test_filter_batch_parity(bpc, w, h):
    from rav1d_jax.ops.dev.ipred import ipred_filter_batch

    rng = np.random.default_rng(bpc + w + h)
    N, off = 10, 128
    tls = _rand_edge(rng, N, bpc)
    fis = rng.integers(0, 5, N).astype(np.int32)

    want = np.zeros((N, h, w), np.int32)
    for i in range(N):
        RI.ipred_filter(want[i], tls[i], off, w, h, int(fis[i]), 0, 0, bpc)
    got = np.asarray(ipred_filter_batch(tls, off, w, h, bpc, filt_idx=fis))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpc", [8, 10])
@pytest.mark.parametrize("ss_hor,ss_ver", [(0, 0), (1, 0), (1, 1)])
@pytest.mark.parametrize("w,h", [(4, 4), (16, 8)])
def test_cfl_ac_batch_parity(bpc, ss_hor, ss_ver, w, h):
    from rav1d_jax.ops.dev.ipred import cfl_ac_batch

    rng = np.random.default_rng(bpc + ss_hor * 2 + ss_ver + w + h)
    N = 12
    ypx = rng.integers(0, (1 << bpc) - 1,
                       (N, h << ss_ver, w << ss_hor)).astype(np.int32)
    w_pads = rng.integers(0, w // 4, N).astype(np.int32)
    h_pads = rng.integers(0, h // 4, N).astype(np.int32)

    want = np.zeros((N, h, w), np.int32)
    for i in range(N):
        ac = np.zeros((h, w), np.int32)
        RI.cfl_ac(ac, ypx[i], int(w_pads[i]), int(h_pads[i]), w, h,
                  ss_hor, ss_ver)
        want[i] = ac
    got = np.asarray(cfl_ac_batch(ypx, w, h, ss_hor, ss_ver,
                                  w_pads=w_pads, h_pads=h_pads))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpc", [8, 10])
def test_cfl_pred_batch_parity(bpc):
    from rav1d_jax.ops.dev.ipred import cfl_pred_batch

    rng = np.random.default_rng(bpc)
    N, h, w = 8, 8, 16
    dcs = rng.integers(0, (1 << bpc) - 1, N).astype(np.int32)
    acs = rng.integers(-4000, 4000, (N, h, w)).astype(np.int32)
    alphas = rng.integers(-16, 17, N).astype(np.int32)

    want = np.zeros((N, h, w), np.int32)
    for i in range(N):
        RI.cfl_pred_apply(want[i], int(dcs[i]), acs[i].astype(np.int16),
                          int(alphas[i]), bpc)
    got = np.asarray(cfl_pred_batch(dcs, acs, alphas, bpc))
    np.testing.assert_array_equal(got, want)


def test_pal_pred_batch_parity():
    from rav1d_jax.ops.dev.ipred import pal_pred_batch

    rng = np.random.default_rng(77)
    N, h, w = 6, 8, 8
    pals = rng.integers(0, 255, (N, 8)).astype(np.int32)
    idxs = rng.integers(0, 8, (N, h, w)).astype(np.int32)
    want = np.zeros((N, h, w), np.int32)
    for i in range(N):
        RI.pal_pred(want[i], pals[i], idxs[i].flatten(), w, h)
    got = np.asarray(pal_pred_batch(pals, idxs))
    np.testing.assert_array_equal(got, want)
