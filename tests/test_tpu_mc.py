"""checkasm-style parity: device (jax) mc/warp kernels vs numpy batch executors
on randomized inputs (tests/checkasm/mc.c analog)."""

import numpy as np
import pytest

from rav1d_jax.ops.ref.mc import compute_8tap_batch, warp_affine_8x8_batch


@pytest.mark.parametrize("bpc", [8, 10])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 8), (32, 32)])
@pytest.mark.parametrize("has_h,has_v", [(1, 1), (1, 0), (0, 1), (0, 0)])
def test_mc_8tap_batch_parity(bpc, w, h, has_h, has_v):
    from rav1d_jax.ops.dev.mc import mc_8tap_batch

    rng = np.random.default_rng(w * 100 + h + bpc)
    vis_w, vis_h = 96, 64
    src = rng.integers(0, (1 << bpc) - 1, (vis_h, vis_w)).astype(np.int32)
    N = 9
    sys_ = rng.integers(-4, vis_h, N)
    sxs = rng.integers(-4, vis_w, N)
    mxs = rng.integers(1, 16, N) * has_h
    mys = rng.integers(1, 16, N) * has_v
    f2ds = rng.integers(0, 9, N)  # exclude bilinear (9)

    want = compute_8tap_batch(src, sys_, sxs, w, h, mxs, mys, f2ds,
                              vis_w, vis_h, bpc)
    got = np.asarray(
        mc_8tap_batch(
            src, sys_, sxs, w, h, bool(has_h), bool(has_v), vis_w, vis_h, bpc,
            mxs=mxs, mys=mys, f2ds=f2ds,
        )
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpc", [8, 10])
def test_warp_8x8_batch_parity(bpc):
    from rav1d_jax.ops.dev.mc import warp_8x8_batch

    rng = np.random.default_rng(3 + bpc)
    vis_w, vis_h = 80, 64
    src = rng.integers(0, (1 << bpc) - 1, (vis_h, vis_w)).astype(np.int32)
    N = 11
    sys_ = rng.integers(-4, vis_h, N)
    sxs = rng.integers(-4, vis_w, N)
    abcds = rng.integers(-512, 512, (N, 4))
    mxs = rng.integers(-(1 << 14), 1 << 14, N) & ~0x3F
    mys = rng.integers(-(1 << 14), 1 << 14, N) & ~0x3F

    dst = np.zeros((vis_h + 32, vis_w + 32), dtype=np.uint16)
    dys = (np.arange(N) % 4) * 8
    dxs = (np.arange(N) // 4) * 8
    warp_affine_8x8_batch(dst, src, dys, dxs, sys_, sxs, abcds, mxs, mys,
                          vis_w, vis_h, bpc)
    want = np.stack([dst[dys[i] : dys[i] + 8, dxs[i] : dxs[i] + 8] for i in range(N)])

    got = np.asarray(
        warp_8x8_batch(src, sys_, sxs, abcds.astype(np.int32),
                       mxs.astype(np.int32), mys.astype(np.int32),
                       vis_w, vis_h, bpc)
    )
    np.testing.assert_array_equal(got, want)


from rav1d_jax.ops.ref import mc as RM


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 16), (32, 8)])
@pytest.mark.parametrize("has_h,has_v", [(1, 1), (1, 0), (0, 1), (0, 0)])
def test_prep_8tap_batch_parity(bpc, w, h, has_h, has_v):
    from rav1d_jax.ops.dev.mc import prep_8tap_batch

    rng = np.random.default_rng(w * 7 + h + bpc + has_h * 2 + has_v)
    vis_w, vis_h = 96, 64
    src = rng.integers(0, (1 << bpc) - 1, (vis_h, vis_w)).astype(np.int32)
    N = 7
    sys_ = rng.integers(3, vis_h - h - 4, N)
    sxs = rng.integers(3, vis_w - w - 4, N)
    mxs = rng.integers(1, 16, N) * has_h
    mys = rng.integers(1, 16, N) * has_v
    f2ds = rng.integers(0, 9, N)

    want = np.stack([
        RM.prep_8tap(src, int(sys_[i]), int(sxs[i]), w, h, int(mxs[i]),
                     int(mys[i]), int(f2ds[i]), bpc)
        for i in range(N)
    ])
    got = np.asarray(prep_8tap_batch(
        src, sys_, sxs, w, h, bool(has_h), bool(has_v), vis_w, vis_h, bpc,
        mxs=mxs, mys=mys, f2ds=f2ds,
    ))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpc", [8, 10])
@pytest.mark.parametrize("is_prep", [False, True])
def test_bilin_batch_parity(bpc, is_prep):
    from rav1d_jax.ops.dev.mc import bilin_batch

    rng = np.random.default_rng(11 + bpc + is_prep)
    vis_w, vis_h = 64, 48
    w, h = 8, 8
    src = rng.integers(0, (1 << bpc) - 1, (vis_h, vis_w)).astype(np.int32)
    N = 16
    sys_ = rng.integers(0, vis_h - h - 1, N)
    sxs = rng.integers(0, vis_w - w - 1, N)
    mxs = rng.integers(0, 16, N)
    mys = rng.integers(0, 16, N)

    want = []
    for i in range(N):
        if is_prep:
            want.append(RM.prep_bilin(src, int(sys_[i]), int(sxs[i]), w, h,
                                      int(mxs[i]), int(mys[i]), bpc))
        else:
            dst = np.zeros((h, w), dtype=np.int32)
            RM.put_bilin(dst, 0, 0, src, int(sys_[i]), int(sxs[i]), w, h,
                         int(mxs[i]), int(mys[i]), bpc)
            want.append(dst)
    got = np.asarray(bilin_batch(src, sys_, sxs, w, h, is_prep, vis_w, vis_h,
                                 bpc, mxs=mxs, mys=mys))
    np.testing.assert_array_equal(got, np.stack(want))


@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_compound_combiners_parity(bpc):
    from rav1d_jax.ops.dev import mc as TM

    rng = np.random.default_rng(5 + bpc)
    N, h, w = 6, 16, 16
    lo, hi = -20000, 20000
    t1 = rng.integers(lo, hi, (N, h, w)).astype(np.int32)
    t2 = rng.integers(lo, hi, (N, h, w)).astype(np.int32)
    wts = rng.integers(0, 17, N)
    msk = rng.integers(0, 65, (N, h, w)).astype(np.int32)

    for i in range(N):
        dst = np.zeros((h, w), np.int32)
        RM.avg(dst, 0, 0, t1[i], t2[i], w, h, bpc)
        np.testing.assert_array_equal(np.asarray(TM.avg_batch(t1, t2, bpc))[i], dst)
        RM.w_avg(dst, 0, 0, t1[i], t2[i], w, h, int(wts[i]), bpc)
        np.testing.assert_array_equal(
            np.asarray(TM.w_avg_batch(t1, t2, wts, bpc))[i], dst)
        RM.mask(dst, 0, 0, t1[i], t2[i], w, h, msk[i], bpc)
        np.testing.assert_array_equal(
            np.asarray(TM.mask_batch(t1, t2, msk, bpc))[i], dst)


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("ss_hor,ss_ver", [(0, 0), (1, 0), (1, 1)])
def test_w_mask_batch_parity(bpc, ss_hor, ss_ver):
    from rav1d_jax.ops.dev.mc import w_mask_batch

    rng = np.random.default_rng(9 + bpc + ss_hor * 2 + ss_ver)
    N, h, w = 5, 16, 32
    t1 = rng.integers(-20000, 20000, (N, h, w)).astype(np.int32)
    t2 = rng.integers(-20000, 20000, (N, h, w)).astype(np.int32)
    signs = rng.integers(0, 2, N)
    gotp, gotm = w_mask_batch(t1, t2, signs, ss_hor, ss_ver, bpc)
    gotp, gotm = np.asarray(gotp), np.asarray(gotm)
    for i in range(N):
        dst = np.zeros((h, w), np.int32)
        m = RM.w_mask(dst, 0, 0, t1[i], t2[i], w, h, int(signs[i]),
                      ss_hor, ss_ver, bpc)
        np.testing.assert_array_equal(gotp[i], dst)
        np.testing.assert_array_equal(gotm[i], m)


def test_blend_batches_parity():
    from rav1d_jax.ops.dev import mc as TM

    rng = np.random.default_rng(17)
    N, h, w = 4, 16, 16
    a = rng.integers(0, 255, (N, h, w)).astype(np.int32)
    b = rng.integers(0, 255, (N, h, w)).astype(np.int32)
    msk = rng.integers(0, 65, (N, h, w)).astype(np.int32)

    got = np.asarray(TM.blend_batch(a, b, msk))
    for i in range(N):
        dst = a[i].copy()
        RM.blend(dst, 0, 0, b[i], w, h, msk[i])
        np.testing.assert_array_equal(got[i], dst)

    got_v = np.asarray(TM.blend_v_batch(a, b, w))
    got_h = np.asarray(TM.blend_h_batch(a, b, h))
    for i in range(N):
        dst = a[i].copy()
        RM.blend_v(dst, 0, 0, b[i], w, h)
        np.testing.assert_array_equal(got_v[i], dst)
        dst = a[i].copy()
        RM.blend_h(dst, 0, 0, b[i], w, h)
        np.testing.assert_array_equal(got_h[i], dst)


@pytest.mark.parametrize("bpc", [8, 10])
@pytest.mark.parametrize("is_prep", [False, True])
def test_mc_8tap_scaled_batch_parity(bpc, is_prep):
    from rav1d_jax.ops.dev.mc import mc_8tap_scaled_batch

    rng = np.random.default_rng(23 + bpc + is_prep)
    vis_w, vis_h = 128, 96
    w, h = 8, 8
    src = rng.integers(0, (1 << bpc) - 1, (vis_h, vis_w)).astype(np.int32)
    N = 6
    dxs = rng.integers(512, 2048, N)   # 0.5x..2x scale steps
    dys = rng.integers(512, 2048, N)
    mxs = rng.integers(0, 1024, N)
    mys = rng.integers(0, 1024, N)
    tmp_h = ((h - 1) * 2048 + 1023 >> 10) + 8
    sys_ = rng.integers(3, vis_h - tmp_h - 1, N)
    sxs = rng.integers(3, vis_w - 2 * w - 8, N)
    f2ds = rng.integers(0, 9, N)

    want = []
    for i in range(N):
        if is_prep:
            want.append(RM.prep_8tap_scaled(
                src, int(sys_[i]), int(sxs[i]), w, h, int(mxs[i]), int(mys[i]),
                int(dxs[i]), int(dys[i]), int(f2ds[i]), bpc))
        else:
            dst = np.zeros((h, w), np.int32)
            RM.put_8tap_scaled(dst, 0, 0, src, int(sys_[i]), int(sxs[i]), w, h,
                               int(mxs[i]), int(mys[i]), int(dxs[i]),
                               int(dys[i]), int(f2ds[i]), bpc)
            want.append(dst)
    got = np.asarray(mc_8tap_scaled_batch(
        src, sys_, sxs, mxs, mys, dxs, dys, w, h, tmp_h, vis_w, vis_h, bpc,
        f2ds=f2ds, is_prep=is_prep,
    ))
    np.testing.assert_array_equal(got, np.stack(want))


@pytest.mark.parametrize("bpc", [8, 10])
@pytest.mark.parametrize("is_prep", [False, True])
def test_bilin_scaled_batch_parity(bpc, is_prep):
    from rav1d_jax.ops.dev.mc import bilin_scaled_batch

    rng = np.random.default_rng(31 + bpc + is_prep)
    vis_w, vis_h = 96, 80
    w, h = 8, 8
    src = rng.integers(0, (1 << bpc) - 1, (vis_h, vis_w)).astype(np.int32)
    N = 6
    dxs = rng.integers(512, 2048, N)
    dys = rng.integers(512, 2048, N)
    mxs = rng.integers(0, 1024, N)
    mys = rng.integers(0, 1024, N)
    tmp_h = ((h - 1) * 2048 + 1023 >> 10) + 2
    sys_ = rng.integers(0, vis_h - tmp_h - 1, N)
    sxs = rng.integers(0, vis_w - 2 * w - 2, N)

    want = []
    for i in range(N):
        if is_prep:
            want.append(RM.prep_bilin_scaled(
                src, int(sys_[i]), int(sxs[i]), w, h, int(mxs[i]), int(mys[i]),
                int(dxs[i]), int(dys[i]), bpc))
        else:
            dst = np.zeros((h, w), np.int32)
            RM.put_bilin_scaled(dst, 0, 0, src, int(sys_[i]), int(sxs[i]),
                                w, h, int(mxs[i]), int(mys[i]), int(dxs[i]),
                                int(dys[i]), bpc)
            want.append(dst)
    got = np.asarray(bilin_scaled_batch(
        src, sys_, sxs, mxs, mys, dxs, dys, w, h, tmp_h, vis_w, vis_h, bpc,
        is_prep=is_prep,
    ))
    np.testing.assert_array_equal(got, np.stack(want))


@pytest.mark.parametrize("bpc", [8, 10])
def test_resize_batch_parity(bpc):
    from rav1d_jax.ops.dev.mc import resize_batch

    rng = np.random.default_rng(41 + bpc)
    h, src_w, dst_w = 24, 64, 100
    src = rng.integers(0, (1 << bpc) - 1, (h, src_w)).astype(np.int32)
    # dav1d superres step/start derivation for this (src_w, dst_w)
    dx = ((src_w << 14) + (dst_w >> 1)) // dst_w
    mx0 = ((-((dst_w - src_w) << 13)) + (dst_w >> 1)) // dst_w + (1 << 13)

    want = np.zeros((h, dst_w), np.int32)
    RM.resize(want, 0, 0, src, 0, 0, dst_w, h, src_w, dx, mx0, bpc)
    got = np.asarray(resize_batch(src, h, dst_w, src_w, dx, mx0, bpc))
    np.testing.assert_array_equal(got, want)
