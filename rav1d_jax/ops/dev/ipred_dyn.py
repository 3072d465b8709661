"""Traced-size batched intra prediction (the wave-scan kernel family).

Unlike ops/dev/ipred.py (one XLA specialization per exact tx size), every
kernel here runs at a static *size class* (CW, CH) while the per-item block
size (w, h) is a traced value: one compiled program per class serves all tx
sizes, which is what lets the engine execute a whole frame's intra wavefront
as a single `lax.scan` (engine/wave2.py) instead of one dispatch per
(wave, size) group.

Semantics parity: src/ipred.rs ipred_*_rust (oracle ops/ref/ipred.py).
Edge layout: `edge` is (B, EL) int32 with EL = 2*CH + 1 + 2*CW and the
top-left sample at C = 2*CH; top pixels ascend from C+1, left pixels
descend from C-1 (matching rav1d's 257-entry topleft buffer, recentred
per class). Predicted pixels beyond an item's (w, h) are garbage and must
be masked by the caller's scatter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...tables.spec_data import (
    DR_INTRA_DERIVATIVE,
    FILTER_INTRA_TAPS,
    SM_WEIGHTS,
)

_CTZ_NP = np.zeros(257, np.int32)
for _i in range(1, 257):
    _CTZ_NP[_i] = (_i & -_i).bit_length() - 1

_EDGE_KERNELS_NP = np.asarray(
    [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]], np.int32
)


def _ctz(v):
    return jnp.asarray(_CTZ_NP)[jnp.clip(v, 0, 256)]


def _gat(edge, pos):
    """edge (B, EL) gathered at clamped positions pos (B, L)."""
    return jnp.take_along_axis(
        edge, jnp.clip(pos, 0, edge.shape[1] - 1), axis=1
    )


def _gat3(vec, idx):
    """vec (B, L) gathered at (B, CH, CW) indices."""
    B = vec.shape[0]
    p = jnp.clip(idx, 0, vec.shape[1] - 1).reshape(B, -1)
    return jnp.take_along_axis(vec, p, axis=1).reshape(idx.shape)


def _scalar(edge, pos):
    """edge gathered at one clamped position per item; pos (B,) -> (B,)."""
    return _gat(edge, pos[:, None])[:, 0]


def _decode_angle(angle):
    return angle & 511, (angle >> 9) & 1, angle >> 10


def _fs_t(wh, a, is_sm):
    """_get_filter_strength with traced wh/angle (src/ipred.rs)."""
    sm = jnp.where(
        wh <= 8,
        jnp.where(a >= 64, 2, jnp.where(a >= 40, 1, 0)),
        jnp.where(
            wh <= 16,
            jnp.where(a >= 48, 2, jnp.where(a >= 20, 1, 0)),
            jnp.where(wh <= 24, jnp.where(a >= 4, 3, 0), 3),
        ),
    )
    ns = jnp.where(
        wh <= 8,
        jnp.where(a >= 56, 1, 0),
        jnp.where(
            wh <= 16,
            jnp.where(a >= 40, 1, 0),
            jnp.where(
                wh <= 24,
                jnp.where(a >= 32, 3, jnp.where(a >= 16, 2, jnp.where(a >= 8, 1, 0))),
                jnp.where(
                    wh <= 32,
                    jnp.where(a >= 32, 3, jnp.where(a >= 4, 2, 1)),
                    3,
                ),
            ),
        ),
    )
    return jnp.where(is_sm != 0, sm, ns)


def _ups_t(wh, a, is_sm):
    lim = jnp.where(is_sm != 0, 8, 16)
    return ((a < 40) & (wh <= lim)).astype(jnp.int32)


def _dr(idx):
    return jnp.asarray(np.asarray(DR_INTRA_DERIVATIVE), jnp.int32)[
        jnp.clip(idx, 0, len(DR_INTRA_DERIVATIVE) - 1)
    ]


def _top(edge, C, CW):
    return edge[:, C + 1 : C + 1 + 2 * CW]


def _left_desc(edge, C, CH):
    # j-th lane = edge[C - 1 - j]
    return edge[:, :C][:, ::-1]


def dc_dyn(edge, C, CW, CH, w, h, bpc):
    i = jnp.arange(2 * CW)[None, :]
    j = jnp.arange(2 * CH)[None, :]
    tsum = jnp.where(i < w[:, None], _top(edge, C, CW), 0).sum(1)
    lsum = jnp.where(j < h[:, None], _left_desc(edge, C, CH), 0).sum(1)
    wh = w + h
    dc = ((wh >> 1) + tsum + lsum) >> _ctz(wh)
    mult_1x2, mult_1x4, base_shift = (
        (0x5556, 0x3334, 16) if bpc == 8 else (0xAAAB, 0x6667, 17)
    )
    mult = jnp.where((w > (h << 1)) | (h > (w << 1)), mult_1x4, mult_1x2)
    dc = jnp.where(w != h, (dc * mult) >> base_shift, dc)
    return jnp.broadcast_to(dc[:, None, None], (edge.shape[0], CH, CW))


def dc_top_dyn(edge, C, CW, CH, w, h, bpc):
    i = jnp.arange(2 * CW)[None, :]
    tsum = jnp.where(i < w[:, None], _top(edge, C, CW), 0).sum(1)
    dc = (tsum + (w >> 1)) >> _ctz(w)
    return jnp.broadcast_to(dc[:, None, None], (edge.shape[0], CH, CW))


def dc_left_dyn(edge, C, CW, CH, w, h, bpc):
    j = jnp.arange(2 * CH)[None, :]
    lsum = jnp.where(j < h[:, None], _left_desc(edge, C, CH), 0).sum(1)
    dc = (lsum + (h >> 1)) >> _ctz(h)
    return jnp.broadcast_to(dc[:, None, None], (edge.shape[0], CH, CW))


def dc_128_dyn(edge, C, CW, CH, w, h, bpc):
    return jnp.full((edge.shape[0], CH, CW), (1 << bpc) >> 1, jnp.int32)


def v_dyn(edge, C, CW, CH, w, h, bpc):
    return jnp.broadcast_to(
        _top(edge, C, CW)[:, None, :CW], (edge.shape[0], CH, CW)
    )


def h_dyn(edge, C, CW, CH, w, h, bpc):
    return jnp.broadcast_to(
        _left_desc(edge, C, CH)[:, :CH, None], (edge.shape[0], CH, CW)
    )


def paeth_dyn(edge, C, CW, CH, w, h, bpc):
    B = edge.shape[0]
    tl = edge[:, C][:, None, None]
    top = _top(edge, C, CW)[:, None, :CW]
    left = _left_desc(edge, C, CH)[:, :CH, None]
    base = left + top - tl
    ldiff = jnp.abs(left - base)
    tdiff = jnp.abs(top - base)
    tldiff = jnp.abs(tl - base)
    return jnp.where(
        (ldiff <= tdiff) & (ldiff <= tldiff),
        jnp.broadcast_to(left, (B, CH, CW)),
        jnp.where(
            tdiff <= tldiff,
            jnp.broadcast_to(top, (B, CH, CW)),
            jnp.broadcast_to(tl, (B, CH, CW)),
        ),
    )


def _sm(idx):
    return jnp.asarray(np.asarray(SM_WEIGHTS), jnp.int32)[
        jnp.clip(idx, 0, len(SM_WEIGHTS) - 1)
    ]


def smooth_dyn(edge, C, CW, CH, w, h, bpc):
    wx = _sm(w[:, None] + jnp.arange(CW)[None, :])[:, None, :]
    wy = _sm(h[:, None] + jnp.arange(CH)[None, :])[:, :, None]
    right = _scalar(edge, C + w)[:, None, None]
    bottom = _scalar(edge, C - h)[:, None, None]
    top = _top(edge, C, CW)[:, None, :CW]
    left = _left_desc(edge, C, CH)[:, :CH, None]
    pred = wy * top + (256 - wy) * bottom + wx * left + (256 - wx) * right
    return (pred + 256) >> 9


def smooth_v_dyn(edge, C, CW, CH, w, h, bpc):
    wy = _sm(h[:, None] + jnp.arange(CH)[None, :])[:, :, None]
    bottom = _scalar(edge, C - h)[:, None, None]
    top = _top(edge, C, CW)[:, None, :CW]
    pred = wy * top + (256 - wy) * bottom
    return jnp.broadcast_to((pred + 128) >> 8, (edge.shape[0], CH, CW))


def smooth_h_dyn(edge, C, CW, CH, w, h, bpc):
    wx = _sm(w[:, None] + jnp.arange(CW)[None, :])[:, None, :]
    right = _scalar(edge, C + w)[:, None, None]
    left = _left_desc(edge, C, CH)[:, :CH, None]
    pred = wx * left + (256 - wx) * right
    return jnp.broadcast_to((pred + 128) >> 8, (edge.shape[0], CH, CW))


def z1_dyn(edge, C, CW, CH, w, h, bpc, angles):
    angle, is_sm, ief = _decode_angle(angles)
    dx = _dr(angle >> 1)
    wh = w + h
    wmin = jnp.minimum(w, h)
    ups = _ups_t(wh, 90 - angle, is_sm) * (ief != 0)
    fs = _fs_t(wh, 90 - angle, is_sm) * (ief != 0)
    pxmax = (1 << bpc) - 1

    Lmax = 2 * (CW + CH)
    i = jnp.arange(Lmax)[None, :]
    hi = (w + wmin)[:, None]  # src_to for s(i) = edge[C+1+clip(i, -1, hi-1)]

    def s(k):
        return _gat(edge, C + 1 + jnp.clip(k, -1, hi - 1))

    raw = s(i)
    K = jnp.asarray(_EDGE_KERNELS_NP)[jnp.maximum(fs, 1) - 1]
    acc = jnp.zeros_like(raw)
    for jj in range(5):
        acc = acc + K[:, jj : jj + 1] * s(i - 2 + jj)
    flt = jnp.where(i < wh[:, None], (acc + 8) >> 4, raw)
    k = i >> 1
    ev = s(k)
    odd = jnp.clip((-s(k - 1) + 9 * ev + 9 * s(k + 1) - s(k + 2) + 8) >> 4, 0, pxmax)
    up = jnp.where((i & 1) == 0, ev, odd)

    u = (ups != 0)[:, None]
    top = jnp.where(u, up, jnp.where((fs > 0)[:, None], flt, raw))
    max_base = jnp.where(
        ups != 0, 2 * wh - 2, jnp.where(fs > 0, wh - 1, w + wmin - 1)
    )[:, None, None]

    dx_e = (dx << ups)[:, None, None]
    binc = (1 + ups)[:, None, None]
    ys = jnp.arange(CH)[None, :, None]
    xs = jnp.arange(CW)[None, None, :]
    xpos = dx_e * (ys + 1)
    frac = xpos & 0x3E
    base = (xpos >> 6) + xs * binc
    idx = jnp.minimum(base, max_base)
    t0 = _gat3(top, idx)
    t1 = _gat3(top, jnp.minimum(idx + 1, Lmax - 1))
    interp = (t0 * (64 - frac) + t1 * frac + 32) >> 6
    fill = _gat3(top, jnp.broadcast_to(max_base, base.shape))
    return jnp.where(base < max_base, interp, fill)


def z3_dyn(edge, C, CW, CH, w, h, bpc, angles):
    angle, is_sm, ief = _decode_angle(angles)
    dy = _dr((270 - angle) >> 1)
    wh = w + h
    hmin = jnp.minimum(w, h)
    ups = _ups_t(wh, angle - 180, is_sm) * (ief != 0)
    fs = _fs_t(wh, angle - 180, is_sm) * (ief != 0)
    pxmax = (1 << bpc) - 1

    Lmax = 2 * (CW + CH)
    i = jnp.arange(Lmax)[None, :]
    # raw: B[i] = edge[C - 1 - i] (tl read directly, no clamp needed within
    # the valid base range; clamp only guards the class padding)
    raw = _gat(edge, C - 1 - i)
    # filtered/upsampled sources read s(k) = edge[C - wh + clip(k, lo, wh)]
    lo = jnp.maximum(w - h, 0)[:, None]
    whc = wh[:, None]

    def s(k):
        return _gat(edge, (C - whc) + jnp.clip(k, lo, whc))

    # filtered: B[i] = filter_out[wh - 1 - i]
    kf = whc - 1 - i
    K = jnp.asarray(_EDGE_KERNELS_NP)[jnp.maximum(fs, 1) - 1]
    acc = jnp.zeros((edge.shape[0], Lmax), jnp.int32)
    for jj in range(5):
        acc = acc + K[:, jj : jj + 1] * s(kf - 2 + jj)
    flt = (acc + 8) >> 4
    # upsampled: B[i] = up_out[2*wh - 2 - i]
    t = 2 * whc - 2 - i
    k = t >> 1
    ev = s(k)
    odd = jnp.clip((-s(k - 1) + 9 * ev + 9 * s(k + 1) - s(k + 2) + 8) >> 4, 0, pxmax)
    up = jnp.where((t & 1) == 0, ev, odd)

    u = (ups != 0)[:, None]
    left = jnp.where(u, up, jnp.where((fs > 0)[:, None], flt, raw))
    max_base = jnp.where(
        ups != 0, 2 * wh - 2, jnp.where(fs > 0, wh - 1, h + hmin - 1)
    )[:, None, None]

    dy_e = (dy << ups)[:, None, None]
    binc = (1 + ups)[:, None, None]
    ys = jnp.arange(CH)[None, :, None]
    xs = jnp.arange(CW)[None, None, :]
    ypos = dy_e * (xs + 1)
    frac = ypos & 0x3E
    base = (ypos >> 6) + ys * binc
    idx = jnp.minimum(base, max_base)
    t0 = _gat3(left, idx)
    t1 = _gat3(left, jnp.minimum(idx + 1, Lmax - 1))
    interp = (t0 * (64 - frac) + t1 * frac + 32) >> 6
    fill = _gat3(left, jnp.broadcast_to(max_base, base.shape))
    return jnp.where(base < max_base, interp, fill)


def z2_dyn(edge, C, CW, CH, w, h, bpc, angles, max_ws, max_hs, smooth_tl):
    angle, is_sm, ief = _decode_angle(angles)
    dy = _dr((angle - 90) >> 1)
    dx = _dr((180 - angle) >> 1)
    wh = w + h
    ua = _ups_t(wh, angle - 90, is_sm) * (ief != 0)
    ul = _ups_t(wh, 180 - angle, is_sm) * (ief != 0)
    fs_a = _fs_t(wh, angle - 90, is_sm) * (ief != 0)
    fs_l = _fs_t(wh, 180 - angle, is_sm) * (ief != 0)
    pxmax = (1 << bpc) - 1

    # top-left smoothing (rav1d_prepare_intra_edges, ipred_prepare.rs:184)
    tl0 = edge[:, C]
    sm_tl = ((edge[:, C - 1] + edge[:, C + 1]) * 5 + tl0 * 6 + 8) >> 4
    edge = edge.at[:, C].set(jnp.where(smooth_tl, sm_tl, tl0))

    EL = edge.shape[1]
    j = jnp.arange(EL)[None, :] - C
    wc = w[:, None]
    hc = h[:, None]

    # above candidates (j >= 1): s_a(k) = edge[C + clip(k, 0, w)]
    k = j >> 1
    sa = lambda kk: _gat(edge, C + jnp.clip(kk, 0, wc))  # noqa: E731
    ev_a = sa(k)
    odd_a = jnp.clip(
        (-sa(k - 1) + 9 * ev_a + 9 * sa(k + 1) - sa(k + 2) + 8) >> 4, 0, pxmax
    )
    up_above = jnp.where((j & 1) == 0, ev_a, odd_a)
    i_a = j - 1
    ra = lambda kk: _gat(edge, C + 1 + jnp.clip(kk, -1, wc - 1))  # noqa: E731
    raw_a = ra(i_a)
    Ka = jnp.asarray(_EDGE_KERNELS_NP)[jnp.maximum(fs_a, 1) - 1]
    acc = jnp.zeros_like(raw_a)
    for jj in range(5):
        acc = acc + Ka[:, jj : jj + 1] * ra(i_a - 2 + jj)
    sm_a = (acc + 8) >> 4
    flt_a = jnp.where(
        (i_a >= 0) & (i_a < max_ws[:, None]) & (fs_a > 0)[:, None], sm_a, raw_a
    )
    above = jnp.where((ua != 0)[:, None], up_above, flt_a)

    # below candidates (j <= -1): s_b(k) = edge[C - h + clip(k, 0, h)]
    tb = j + 2 * hc
    kb = tb >> 1
    sb = lambda kk: _gat(edge, (C - hc) + jnp.clip(kk, 0, hc))  # noqa: E731
    ev_b = sb(kb)
    odd_b = jnp.clip(
        (-sb(kb - 1) + 9 * ev_b + 9 * sb(kb + 1) - sb(kb + 2) + 8) >> 4, 0, pxmax
    )
    up_below = jnp.where((tb & 1) == 0, ev_b, odd_b)
    i_l = j + hc
    rl = lambda kk: _gat(edge, (C - hc) + jnp.clip(kk, 0, hc))  # noqa: E731
    raw_l = rl(i_l)
    Kl = jnp.asarray(_EDGE_KERNELS_NP)[jnp.maximum(fs_l, 1) - 1]
    accl = jnp.zeros_like(raw_l)
    for jj in range(5):
        accl = accl + Kl[:, jj : jj + 1] * rl(i_l - 2 + jj)
    sm_l = (accl + 8) >> 4
    flt_l = jnp.where(
        (i_l >= (hc - max_hs[:, None])) & (i_l < hc) & (fs_l > 0)[:, None],
        sm_l,
        raw_l,
    )
    below = jnp.where((ul != 0)[:, None], up_below, flt_l)

    edge_v = jnp.where(j > 0, above, jnp.where(j < 0, below, edge[:, C : C + 1]))

    dx_e = (dx << ua)[:, None, None]
    ys = jnp.arange(CH)[None, :, None]
    xs = jnp.arange(CW)[None, None, :]
    xpos = ((1 + ua) << 6)[:, None, None] - dx_e * (ys + 1)
    base_x = (xpos >> 6) + xs * (1 + ua)[:, None, None]
    frac_x = xpos & 0x3E
    ypos = (ys << (6 + ul)[:, None, None]) - (dy << ul)[:, None, None] * (xs + 1)
    base_y = ypos >> 6
    frac_y = ypos & 0x3E

    top_v = _gat3(edge_v, C + base_x) * (64 - frac_x) + _gat3(
        edge_v, C + base_x + 1
    ) * frac_x
    left_off = C - (1 + ul)[:, None, None]
    left_v = _gat3(edge_v, left_off - base_y) * (64 - frac_y) + _gat3(
        edge_v, left_off - base_y - 1
    ) * frac_y
    v = jnp.where(base_x >= 0, top_v, left_v)
    return (v + 32) >> 6


def filter_dyn(edge, C, CW, CH, w, h, bpc, filt_idx):
    """FILTER_PRED with traced (w, h): masked row-major fori over the class
    2x4 sub-block grid, vmapped over items (src/ipred.rs ipred_filter_rust)."""
    taps = jnp.asarray(np.asarray(FILTER_INTRA_TAPS), jnp.int32)  # (5, 8, 7)
    pxmax = (1 << bpc) - 1
    nxg = CW // 4
    nyg = CH // 2

    def per_item(e, fi, wi, hi):
        fm = taps[jnp.clip(fi & 511, 0, 4)]  # (8, 7)
        buf = jnp.zeros((CH + 1, CW + 1), jnp.int32)
        buf = buf.at[0, 1:].set(e[C + 1 : C + 1 + CW])
        buf = buf.at[1:, 0].set(e[:C][::-1][:CH])
        buf = buf.at[0, 0].set(e[C])

        def step(ib, buf):
            y = (ib // nxg) * 2
            x = (ib % nxg) * 4
            active = (x < wi) & (y < hi)
            row = jax.lax.dynamic_slice(buf, (y, x), (1, 5))[0]
            col = jax.lax.dynamic_slice(buf, (y + 1, x), (2, 1))[:, 0]
            ps = jnp.concatenate([row, col])
            vals = jnp.clip((fm @ ps + 8) >> 4, 0, pxmax)
            nb = jax.lax.dynamic_update_slice(buf, vals[:4][None, :], (y + 1, x + 1))
            nb = jax.lax.dynamic_update_slice(nb, vals[4:][None, :], (y + 2, x + 1))
            return jnp.where(active, nb, buf)

        buf = jax.lax.fori_loop(0, nxg * nyg, step, buf)
        return buf[1:, 1:]

    return jax.vmap(per_item)(edge, filt_idx, w, h)


def cfl_ac_dyn(ypx, CW, CH, w, h, ss_hor, ss_ver, w_pads, h_pads):
    """cfl_ac with traced (w, h): ypx (B, CH << ss_ver, CW << ss_hor) luma
    pixels from the block origin -> (B, CH, CW) ac values."""
    s = ypx.astype(jnp.int32)
    if ss_hor:
        s = s[:, :, 0::2] + s[:, :, 1::2]
    if ss_ver:
        s = s[:, 0::2, :] + s[:, 1::2, :]
    s = s << (1 + (ss_ver == 0) + (ss_hor == 0))
    valid_w = (w - 4 * w_pads)[:, None, None]
    valid_h = (h - 4 * h_pads)[:, None, None]
    ys = jnp.minimum(jnp.arange(CH)[None, :, None], valid_h - 1)
    xs = jnp.minimum(jnp.arange(CW)[None, None, :], valid_w - 1)
    B = ypx.shape[0]
    flat = s.reshape(B, -1)
    ac = jnp.take_along_axis(
        flat, jnp.clip(ys * CW + xs, 0, CH * CW - 1).reshape(B, -1), axis=1
    ).reshape(B, CH, CW)
    log2sz = _ctz(w) + _ctz(h)
    mask = (jnp.arange(CW)[None, None, :] < w[:, None, None]) & (
        jnp.arange(CH)[None, :, None] < h[:, None, None]
    )
    total = (jnp.left_shift(1, log2sz) >> 1) + jnp.where(mask, ac, 0).sum((1, 2))
    avg = total >> log2sz
    return ac - avg[:, None, None]


def cfl_pred_dyn(dcs, acs, alphas, bpc):
    diff = alphas[:, None, None] * acs
    adj = jnp.where(
        diff < 0, -((jnp.abs(diff) + 32) >> 6), (jnp.abs(diff) + 32) >> 6
    )
    return jnp.clip(dcs[:, None, None] + adj, 0, (1 << bpc) - 1)
