"""Device post-filter chain (engine v2).

Raw whole-frame filter kernels, traced inside the engine's single filter
program (engine/mega.py filter_prog): deblock, CDEF, super-resolution, and
loop restoration run on the device planes, fed by the per-frame
mask/level/stripe descriptors the host syntax pass packed into the frame
blob (engine/run2.py). Role parity: the filter_sbrow chain (src/recon.rs:4047-4338)
and its drivers src/lf_apply.rs, src/cdef_apply.rs, src/lr_apply.rs, each
re-expressed as dense masked passes; bit-exactness per pass is held to the
host numpy drivers (recon/{lf,cdef_apply,lr_apply}.py), which the meson MD5
sweep oracles.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..headers import PixelLayout, RestorationType
from ..ops.ref.lf import WRITE_EXTENT, calc_eih
from ..ops.dev.cdef import MISSING, cdef_filter_batch, find_dir_batch
from ..ops.dev.lf import filter_lines_batch
from ..ops.dev.lr import sgr_batch, wiener_batch


# --------------------------------------------------------------------------
# deblock
# --------------------------------------------------------------------------


def lf_dir_pass_raw(plane, cmap, lmap, eih, luma, hor, bpc):
    """All three width classes of one (plane, direction) deblock pass.

    plane: (H, W) int32; cmap/lmap: (nh4, nw4) final edge class / level maps
    (host-resolved: neighbour-level fallback + tile fixups done); eih: (2, 64)
    E/I luts. hor transposes in-kernel so the same math serves both
    directions (recon/lf.py run()).
    """
    if hor:
        plane = plane.T
    nh4, nw4 = cmap.shape
    H = nh4 * 4
    # zero padding mirrors the host driver's pad array exactly
    pad = jnp.pad(plane, ((8, 8), (8, 8 + 8)))
    Wp = pad.shape[1] - (pad.shape[1] % 4)
    padr = pad[:, :Wp].reshape(pad.shape[0], Wp // 4, 4)

    lines4 = jnp.repeat(lmap, 4, axis=0)  # (H, nw4)
    L = lines4.reshape(-1)
    E = eih[0][L]
    I = eih[1][L]
    Hh = L >> 4

    for cls_ in (1, 2, 3):
        wd = (4 << (cls_ - 1)) if luma else (4 + 2 * (cls_ - 1))
        # window col k for cell x lives at pad col x*4 + k = group x + k//4
        win = jnp.stack(
            [padr[8 : 8 + H, (k >> 2) : (k >> 2) + nw4, k & 3]
             for k in range(16)],
            axis=-1,
        )  # (H, nw4, 16)
        out = filter_lines_batch(win.reshape(-1, 16), E, I, Hh, wd, bpc)
        out = out.reshape(H, nw4, 16)
        sel = jnp.repeat((cmap == cls_) & (lmap != 0), 4, axis=0)
        lo, hi = WRITE_EXTENT[wd]
        for k in range(lo, hi):
            cur = padr[8 : 8 + H, (k >> 2) : (k >> 2) + nw4, k & 3]
            padr = padr.at[8 : 8 + H, (k >> 2) : (k >> 2) + nw4, k & 3].set(
                jnp.where(sel, out[:, :, k], cur)
            )
    res = padr.reshape(pad.shape[0], Wp)[8 : 8 + plane.shape[0],
                                         8 : 8 + plane.shape[1]]
    return res.T if hor else res


# --------------------------------------------------------------------------
# cdef
# --------------------------------------------------------------------------


def cdef_pass_raw(planes, maps, damping, nby, nbx, bh, bw, ss_hor, ss_ver, uv422,
              bpc):
    """Dense whole-frame CDEF: direction search on pre-CDEF luma + filter of
    every active 8x8 unit, all planes (recon/cdef_apply.py apply_cdef)."""
    y_pri, y_sec, uv_lvl, uv_pri, uv_sec = (
        maps[0], maps[1], maps[2], maps[3], maps[4]
    )
    N = nby * nbx

    ys = jnp.arange(nby) * 8
    xs = jnp.arange(nbx) * 8
    ones_x = jnp.ones(nbx, bool)[None, :]
    # unit availability at frame edges (cdef_apply.rs:36)
    have_t = (jnp.arange(nby) > 0)[:, None] & ones_x
    have_b = ((jnp.arange(nby) * 2 + 2) < bh)[:, None] & ones_x
    have_l = jnp.ones(nby, bool)[:, None] & (jnp.arange(nbx) > 0)[None, :]
    have_r = jnp.ones(nby, bool)[:, None] & ((jnp.arange(nbx) * 2 + 2) < bw)[None, :]

    def windows(src, cys, cxs, ch, cw):
        padp = jnp.pad(src, 2, constant_values=MISSING)
        rows = cys[:, None] + jnp.arange(ch + 4)[None, :]
        cols = cxs[:, None] + jnp.arange(cw + 4)[None, :]
        win = padp[rows[:, None, :, None], cols[None, :, None, :]]
        # (nby, nbx, ch+4, cw+4); mask unavailable borders
        win = jnp.where(have_t[:, :, None, None]
                        | (jnp.arange(ch + 4) >= 2)[None, None, :, None],
                        win, MISSING)
        win = jnp.where(have_b[:, :, None, None]
                        | (jnp.arange(ch + 4) < ch + 2)[None, None, :, None],
                        win, MISSING)
        win = jnp.where(have_l[:, :, None, None]
                        | (jnp.arange(cw + 4) >= 2)[None, None, None, :],
                        win, MISSING)
        win = jnp.where(have_r[:, :, None, None]
                        | (jnp.arange(cw + 4) < cw + 2)[None, None, None, :],
                        win, MISSING)
        return win.reshape(N, ch + 4, cw + 4)

    # direction search on pre-CDEF luma
    pre_y = planes[0]
    rows = ys[:, None] + jnp.arange(8)[None, :]
    cols = xs[:, None] + jnp.arange(8)[None, :]
    blocks = pre_y[rows[:, None, :, None], cols[None, :, None, :]]
    direction, variance = find_dir_batch(
        blocks.reshape(N, 8, 8).astype(jnp.int32), bpc
    )

    ypri_f = y_pri.reshape(-1)
    ysec_f = y_sec.reshape(-1)
    # variance-adjusted primary strength (cdef.rs adjust_strength)
    v6 = variance >> 6
    lg = 31 - jax.lax.clz(jnp.maximum(jnp.minimum(v6, 4095), 1))
    i = jnp.where(v6 >= 4096, 12, jnp.minimum(lg, 12))
    adj = (ypri_f * (4 + i) + 8) >> 4
    pri_eff = jnp.where(ypri_f > 0, jnp.where(variance == 0, 0, adj), 0)
    dir_eff = jnp.where(ypri_f > 0, direction, 0)
    do_y = (pri_eff > 0) | (ysec_f > 0)

    wins = windows(pre_y, ys, xs, 8, 8)
    outy = cdef_filter_batch(wins, pri_eff, ysec_f, dir_eff,
                             jnp.full((N,), damping, jnp.int32), bpc)
    newy = planes[0]
    sel = do_y.reshape(nby, nbx)[:, :, None, None]
    blk = newy[rows[:, None, :, None], cols[None, :, None, :]]
    outy = jnp.where(sel, outy.reshape(nby, nbx, 8, 8), blk)
    newy = newy.at[rows[:, None, :, None], cols[None, :, None, :]].set(outy)
    planes = planes.at[0].set(newy)

    if uv422 >= 0:  # chroma present
        UV_DIRS = jnp.asarray(
            [[0, 1, 2, 3, 4, 5, 6, 7], [7, 0, 2, 4, 5, 6, 6, 6]], jnp.int32
        )[uv422]
        uvp = uv_pri.reshape(-1)
        uvs = uv_sec.reshape(-1)
        do_uv = uv_lvl.reshape(-1) != 0
        uvdir = jnp.where(uvp > 0, UV_DIRS[direction], 0)
        ch, cw = 8 >> ss_ver, 8 >> ss_hor
        cys = (ys >> ss_ver)
        cxs = (xs >> ss_hor)
        crows = cys[:, None] + jnp.arange(ch)[None, :]
        ccols = cxs[:, None] + jnp.arange(cw)[None, :]
        seluv = do_uv.reshape(nby, nbx)[:, :, None, None]
        for pl in (1, 2):
            src = planes[pl]
            wins = windows(src, cys, cxs, ch, cw)
            out = cdef_filter_batch(wins, uvp, uvs, uvdir,
                                    jnp.full((N,), damping - 1, jnp.int32),
                                    bpc)
            blk = src[crows[:, None, :, None], ccols[None, :, None, :]]
            out = jnp.where(seluv, out.reshape(nby, nbx, ch, cw), blk)
            src = src.at[crows[:, None, :, None],
                         ccols[None, :, None, :]].set(out)
            planes = planes.at[pl].set(src)
    return planes


# --------------------------------------------------------------------------
# super-resolution
# --------------------------------------------------------------------------


def resize_plane_raw(src, h, dst_w, src_w, dx, mx0, bpc, out_w):
    """Horizontal 8-tap resample (mc.rs resize_rust:1114) with traced
    step/start; out_w = padded output width (zero-filled tail)."""
    from ..tables import spec_data as _sd

    RF = jnp.asarray(np.asarray(_sd.RESIZE_FILTER), jnp.int32)
    pxmax = (1 << bpc) - 1
    pos = mx0 + jnp.arange(dst_w) * dx
    src_x = -1 + (pos >> 14) - (mx0 >> 14)
    filt = RF[(pos & 0x3FFF) >> 8]
    acc = jnp.zeros((h, dst_w), jnp.int32)
    for k in range(8):
        cols = jnp.clip(src_x + k - 3, 0, src_w - 1)
        acc = acc + filt[None, :, k] * src[:h, cols].astype(jnp.int32)
    out = jnp.clip((-acc + 64) >> 7, 0, pxmax)
    return jnp.pad(out, ((0, 0), (0, out_w - dst_w)))


# --------------------------------------------------------------------------
# loop restoration
# --------------------------------------------------------------------------

# stripe descriptor rows
(S_X0, S_Y0, S_W, S_H, S_XLO, S_XHI, S_TOP0, S_TOP1, S_BOT0, S_BOT1,
 S_P0, S_P1, S_P2, S_P3, S_P4, S_P5) = range(16)


def _gather_stripes(cat, d, W6):
    """cat: (2*H, W) concat(pre_lr, lpf); d: (16, N). -> (N, 70, W6)."""
    i = jnp.arange(70)[None, :]
    h = d[S_H][:, None]
    y0 = d[S_Y0][:, None]
    inner = y0 + jnp.clip(i - 3, 0, jnp.maximum(h - 1, 0))
    rmap = jnp.where(
        i < 2, d[S_TOP0][:, None],
        jnp.where(
            i < 3, d[S_TOP1][:, None],
            jnp.where(
                i < 3 + h, inner,
                jnp.where(i == 3 + h, d[S_BOT0][:, None], d[S_BOT1][:, None]),
            ),
        ),
    )
    c = jnp.arange(W6)[None, :]
    cmap = jnp.clip(d[S_X0][:, None] - 3 + c, d[S_XLO][:, None],
                    d[S_XHI][:, None])
    return cat[rmap[:, :, None], cmap[:, None, :]].astype(jnp.int32)


def _lr_scatter(pf, out, d, aw):
    r = jnp.arange(out.shape[1])
    c = jnp.arange(out.shape[2])
    idx = ((d[S_Y0][:, None, None] + r[None, :, None]) * aw
           + d[S_X0][:, None, None] + c[None, None, :])
    valid = (r[None, :, None] < d[S_H][:, None, None]) & (
        c[None, None, :] < d[S_W][:, None, None]
    )
    big = jnp.iinfo(jnp.int32).max
    return pf.at[jnp.where(valid, idx, big)].set(out, mode="drop")


def lr_wiener_pass_raw(pf, cat, d, W, bpc, aw):
    tmps = _gather_stripes(cat, d, W + 6)
    out = wiener_batch(tmps, jnp.stack([d[S_P0], d[S_P1], d[S_P2]], 1),
                       jnp.stack([d[S_P3], d[S_P4], d[S_P5]], 1), W, 64, bpc)
    return _lr_scatter(pf, out, d, aw)


def lr_sgr_pass_raw(pf, cat, d, W, kind, bpc, aw):
    tmps = _gather_stripes(cat, d, W + 6)
    cur = tmps[:, 3 : 3 + 64, 3 : 3 + W]
    out = sgr_batch(cur, tmps, d[S_P0], d[S_P1],
                    jnp.stack([d[S_P2], d[S_P3]], 1), W, 64, kind, bpc)
    return _lr_scatter(pf, out, d, aw)


lf_dir_pass = partial(jax.jit, static_argnums=(4, 5, 6), donate_argnums=(0,))(
    lf_dir_pass_raw
)
cdef_pass = partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8, 9, 10))(
    cdef_pass_raw
)
resize_plane = partial(jax.jit, static_argnums=(1, 2, 3, 6, 7))(
    resize_plane_raw
)
lr_wiener_pass = partial(
    jax.jit, static_argnums=(3, 4, 5), donate_argnums=(0,)
)(lr_wiener_pass_raw)
lr_sgr_pass = partial(
    jax.jit, static_argnums=(3, 4, 5, 6), donate_argnums=(0,)
)(lr_sgr_pass_raw)
