"""Batched motion compensation on the device (jax.numpy, jit-compiled).

The same gather→separable-filter→scatter dataflow as the CPU batch
executors (ops/ref/mc.py compute_8tap_batch / warp_affine_8x8_batch),
expressed in jnp: per-block subpel filter rows are fetched with one take,
the 8-tap convolutions unroll into 8 fused multiply-adds over shifted
window slices (VPU-friendly; the MXU path is a (N*h, 8) x (8,) contraction
XLA forms from the same graph). Exact integer arithmetic in int32.

Parity: src/mc.rs put_8tap_rust:130 / warp_affine_8x8_rust:896 semantics,
validated against ops/ref/mc.py in the mc parity tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...tables.spec_data import (
    MC_SUBPEL_FILTERS,
    MC_WARP_FILTER,
    OBMC_MASKS,
    RESIZE_FILTER,
)
from ..ref.mc import FILTER_DIR, intermediate_bits


def _i16(a):
    return ((a + 0x8000) & 0xFFFF) - 0x8000


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 9))
def mc_8tap_batch(src, sys_, sxs, w, h, has_h, has_v, vis_w, vis_h, bpc,
                  mxs=None, mys=None, f2ds=None):
    """Batched put_8tap: src (H, W) int32 plane; sys_/sxs (N,) full-pel
    coords; mxs/mys (N,) subpel phases; f2ds (N,) filter2d codes.
    Returns (N, h, w) int32 pixels. Coordinate clamping == emu_edge."""
    F = jnp.asarray(np.asarray(MC_SUBPEL_FILTERS), jnp.int32)
    FD = jnp.asarray(np.asarray(FILTER_DIR), jnp.int32)[f2ds]
    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1

    def gather(y0s, nrow, x0s, ncol):
        rows = jnp.clip(y0s[:, None] + jnp.arange(nrow)[None, :], 0, vis_h - 1)
        cols = jnp.clip(x0s[:, None] + jnp.arange(ncol)[None, :], 0, vis_w - 1)
        return src[rows[:, :, None], cols[:, None, :]].astype(jnp.int32)

    def hrow():
        i = jnp.where(w > 4, FD[:, 0], 3 + (FD[:, 0] & 1))
        return F[i, mxs - 1]

    def vrow():
        i = jnp.where(h > 4, FD[:, 1], 3 + (FD[:, 1] & 1))
        return F[i, mys - 1]

    if has_h and has_v:
        win = gather(sys_ - 3, h + 7, sxs - 3, w + 7)
        fh, fv = hrow(), vrow()
        mid = jnp.zeros((win.shape[0], h + 7, w), jnp.int32)
        for k in range(8):
            mid = mid + fh[:, k, None, None] * win[:, :, k : k + w]
        sh = 6 - ib
        mid = _i16((mid + ((1 << sh) >> 1)) >> sh)
        out = jnp.zeros((win.shape[0], h, w), jnp.int32)
        for k in range(8):
            out = out + fv[:, k, None, None] * mid[:, k : k + h, :]
        sh = 6 + ib
        out = jnp.clip((out + ((1 << sh) >> 1)) >> sh, 0, pxmax)
    elif has_h:
        win = gather(sys_, h, sxs - 3, w + 7)
        fh = hrow()
        out = jnp.zeros((win.shape[0], h, w), jnp.int32)
        for k in range(8):
            out = out + fh[:, k, None, None] * win[:, :, k : k + w]
        rnd = 32 + ((1 << (6 - ib)) >> 1)
        out = jnp.clip((out + rnd) >> 6, 0, pxmax)
    elif has_v:
        win = gather(sys_ - 3, h + 7, sxs, w)
        fv = vrow()
        out = jnp.zeros((win.shape[0], h, w), jnp.int32)
        for k in range(8):
            out = out + fv[:, k, None, None] * win[:, k : k + h, :]
        out = jnp.clip((out + 32) >> 6, 0, pxmax)
    else:
        out = gather(sys_, h, sxs, w)
    return out


_WARP_F_NP = np.asarray(MC_WARP_FILTER)


def _warp_filters():
    # converted per trace (folds to a constant; caching a jnp array in a
    # global would leak tracers across jit scopes)
    return jnp.asarray(_WARP_F_NP, jnp.int32)


@partial(jax.jit, static_argnums=(8,))
def warp_8x8_batch(src, sys_, sxs, abcds, mxs, mys, vis_w, vis_h, bpc):
    """Batched 8x8 warp tiles: per-tile affine phase ramps select the 64
    warp filter rows; two 8-tap passes over a 15x15 clamp-gathered window.
    Parity: warp_affine_8x8 (ops/ref/mc.py warp_affine_8x8_batch)."""
    F = _warp_filters()
    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1

    rows = jnp.clip(sys_[:, None] - 3 + jnp.arange(15)[None, :], 0, vis_h - 1)
    cols = jnp.clip(sxs[:, None] - 3 + jnp.arange(15)[None, :], 0, vis_w - 1)
    region = src[rows[:, :, None], cols[:, None, :]].astype(jnp.int32)

    ys = jnp.arange(15)[None, :, None]
    xs = jnp.arange(8)[None, None, :]
    tmx = mxs[:, None, None] + ys * abcds[:, 1, None, None] + xs * abcds[:, 0, None, None]
    taps = F[64 + ((tmx + 512) >> 10)]  # (N, 15, 8, 8)
    sh = 7 - ib
    mid = jnp.zeros(region.shape[:2] + (8,), jnp.int32)
    for k in range(8):
        mid = mid + taps[:, :, :, k] * region[:, :, k : k + 8]
    mid = _i16((mid + ((1 << sh) >> 1)) >> sh)  # (N, 15, 8)

    ys8 = jnp.arange(8)[None, :, None]
    tmy = mys[:, None, None] + ys8 * abcds[:, 3, None, None] + xs * abcds[:, 2, None, None]
    vtaps = F[64 + ((tmy + 512) >> 10)]  # (N, 8, 8, 8)
    v = jnp.zeros((region.shape[0], 8, 8), jnp.int32)
    for k in range(8):
        v = v + vtaps[:, :, :, k] * mid[:, k : k + 8, :]
    sh = 7 + ib
    return jnp.clip((v + ((1 << sh) >> 1)) >> sh, 0, pxmax)


@partial(jax.jit, static_argnums=(8,))
def warp_8x8t_batch(src, sys_, sxs, abcds, mxs, mys, vis_w, vis_h, bpc):
    """Batched 8x8 warp prep tiles (compound intermediates; mc.rs
    warp_affine_8x8t_rust semantics: prep rounding, i16 wrap, no clip)."""
    F = _warp_filters()
    ib = intermediate_bits(bpc)

    rows = jnp.clip(sys_[:, None] - 3 + jnp.arange(15)[None, :], 0, vis_h - 1)
    cols = jnp.clip(sxs[:, None] - 3 + jnp.arange(15)[None, :], 0, vis_w - 1)
    region = src[rows[:, :, None], cols[:, None, :]].astype(jnp.int32)

    ys = jnp.arange(15)[None, :, None]
    xs = jnp.arange(8)[None, None, :]
    tmx = mxs[:, None, None] + ys * abcds[:, 1, None, None] + xs * abcds[:, 0, None, None]
    taps = F[64 + ((tmx + 512) >> 10)]
    sh = 7 - ib
    mid = jnp.zeros(region.shape[:2] + (8,), jnp.int32)
    for k in range(8):
        mid = mid + taps[:, :, :, k] * region[:, :, k : k + 8]
    mid = _i16((mid + ((1 << sh) >> 1)) >> sh)

    ys8 = jnp.arange(8)[None, :, None]
    tmy = mys[:, None, None] + ys8 * abcds[:, 3, None, None] + xs * abcds[:, 2, None, None]
    vtaps = F[64 + ((tmy + 512) >> 10)]
    v = jnp.zeros((region.shape[0], 8, 8), jnp.int32)
    for k in range(8):
        v = v + vtaps[:, :, :, k] * mid[:, k : k + 8, :]
    bias = 0 if bpc == 8 else 8192
    return _i16(((v + 64) >> 7) - bias)


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 9))
def prep_8tap_batch(src, sys_, sxs, w, h, has_h, has_v, vis_w, vis_h, bpc,
                    mxs=None, mys=None, f2ds=None):
    """Batched prep_8tap (compound intermediates; src/mc.rs prep_8tap_rust:277
    semantics): returns (N, h, w) int32 'tmp' values (i16-wrapped, biased).
    Coordinate clamping == emu_edge."""
    F = jnp.asarray(np.asarray(MC_SUBPEL_FILTERS), jnp.int32)
    FD = jnp.asarray(np.asarray(FILTER_DIR), jnp.int32)[f2ds]
    ib = intermediate_bits(bpc)
    bias = 0 if bpc == 8 else 8192

    def gather(y0s, nrow, x0s, ncol):
        rows = jnp.clip(y0s[:, None] + jnp.arange(nrow)[None, :], 0, vis_h - 1)
        cols = jnp.clip(x0s[:, None] + jnp.arange(ncol)[None, :], 0, vis_w - 1)
        return src[rows[:, :, None], cols[:, None, :]].astype(jnp.int32)

    def hrow():
        i = jnp.where(w > 4, FD[:, 0], 3 + (FD[:, 0] & 1))
        return F[i, mxs - 1]

    def vrow():
        i = jnp.where(h > 4, FD[:, 1], 3 + (FD[:, 1] & 1))
        return F[i, mys - 1]

    if has_h and has_v:
        win = gather(sys_ - 3, h + 7, sxs - 3, w + 7)
        fh, fv = hrow(), vrow()
        mid = jnp.zeros((win.shape[0], h + 7, w), jnp.int32)
        for k in range(8):
            mid = mid + fh[:, k, None, None] * win[:, :, k : k + w]
        sh = 6 - ib
        mid = _i16((mid + ((1 << sh) >> 1)) >> sh)
        out = jnp.zeros((win.shape[0], h, w), jnp.int32)
        for k in range(8):
            out = out + fv[:, k, None, None] * mid[:, k : k + h, :]
        out = ((out + 32) >> 6) - bias
    elif has_h:
        win = gather(sys_, h, sxs - 3, w + 7)
        fh = hrow()
        out = jnp.zeros((win.shape[0], h, w), jnp.int32)
        for k in range(8):
            out = out + fh[:, k, None, None] * win[:, :, k : k + w]
        sh = 6 - ib
        out = ((out + ((1 << sh) >> 1)) >> sh) - bias
    elif has_v:
        win = gather(sys_ - 3, h + 7, sxs, w)
        fv = vrow()
        out = jnp.zeros((win.shape[0], h, w), jnp.int32)
        for k in range(8):
            out = out + fv[:, k, None, None] * win[:, k : k + h, :]
        sh = 6 - ib
        out = ((out + ((1 << sh) >> 1)) >> sh) - bias
    else:
        out = (gather(sys_, h, sxs, w) << ib) - bias
    return _i16(out)


@partial(jax.jit, static_argnums=(3, 4, 5, 8))
def bilin_batch(src, sys_, sxs, w, h, is_prep, vis_w, vis_h, bpc,
                mxs=None, mys=None):
    """Batched put/prep_bilin (mc.rs put_bilin_rust:431 / prep_bilin_rust:543).
    Per-item mx/my may be zero; all four phase cases fused with selects."""
    ib = intermediate_bits(bpc)
    ird = (1 << ib) >> 1
    pxmax = (1 << bpc) - 1
    bias = 0 if bpc == 8 else 8192

    rows = jnp.clip(sys_[:, None] + jnp.arange(h + 1)[None, :], 0, vis_h - 1)
    cols = jnp.clip(sxs[:, None] + jnp.arange(w + 1)[None, :], 0, vis_w - 1)
    win = src[rows[:, :, None], cols[:, None, :]].astype(jnp.int32)

    mx = mxs[:, None, None]
    my = mys[:, None, None]
    sh_h = 4 - ib
    hrnd = (1 << sh_h) >> 1
    # horizontal pass -> (N, h+1, w); mid_f is the mx!=0 filtered i16 path,
    # raw the mx==0 passthrough (the reference never shifts raw before a
    # vertical-only pass)
    hsrc = win[:, :, :w]
    hf = 16 * hsrc + mx * (win[:, :, 1 : w + 1] - hsrc)
    mid_f = _i16((hf + hrnd) >> sh_h)
    # vertical pass over both candidates
    vf_f = 16 * mid_f[:, :h, :] + my * (mid_f[:, 1 : h + 1, :] - mid_f[:, :h, :])
    vf_r = 16 * hsrc[:, :h, :] + my * (hsrc[:, 1 : h + 1, :] - hsrc[:, :h, :])
    if is_prep:
        out = jnp.where(
            my != 0,
            jnp.where(mx != 0, (vf_f + 8) >> 4, (vf_r + hrnd) >> sh_h),
            jnp.where(mx != 0, (hf[:, :h, :] + hrnd) >> sh_h,
                      hsrc[:, :h, :] << ib),
        )
        return _i16(out - bias)
    sh_v = 4 + ib
    out = jnp.where(
        my != 0,
        jnp.where(mx != 0, (vf_f + ((1 << sh_v) >> 1)) >> sh_v,
                  (vf_r + 8) >> 4),
        jnp.where(mx != 0, (mid_f[:, :h, :] + ird) >> ib, hsrc[:, :h, :]),
    )
    return jnp.clip(out, 0, pxmax)


@partial(jax.jit, static_argnums=(2,))
def avg_batch(tmp1, tmp2, bpc):
    """mc.rs avg_rust:654: (N, h, w) compound average."""
    ib = intermediate_bits(bpc)
    rnd = (1 << ib) + (0 if bpc == 8 else 8192) * 2
    out = (tmp1 + tmp2 + rnd) >> (ib + 1)
    return jnp.clip(out, 0, (1 << bpc) - 1)


@partial(jax.jit, static_argnums=(3,))
def w_avg_batch(tmp1, tmp2, weights, bpc):
    """mc.rs w_avg_rust:681; weights (N,) in 0..16 applied to tmp1."""
    ib = intermediate_bits(bpc)
    rnd = (8 << ib) + (0 if bpc == 8 else 8192) * 16
    wts = weights[:, None, None]
    out = (tmp1 * wts + tmp2 * (16 - wts) + rnd) >> (ib + 4)
    return jnp.clip(out, 0, (1 << bpc) - 1)


@partial(jax.jit, static_argnums=(3,))
def mask_batch(tmp1, tmp2, msk, bpc):
    """mc.rs mask_rust:711; msk (N, h, w) in 0..64 applied to tmp1."""
    ib = intermediate_bits(bpc)
    rnd = (32 << ib) + (0 if bpc == 8 else 8192) * 64
    m = msk.astype(jnp.int32)
    out = (tmp1 * m + tmp2 * (64 - m) + rnd) >> (ib + 6)
    return jnp.clip(out, 0, (1 << bpc) - 1)


@partial(jax.jit, static_argnums=(3, 4, 5))
def w_mask_batch(tmp1, tmp2, signs, ss_hor, ss_ver, bpc):
    """mc.rs w_mask_rust:814: returns (pixels, chroma-subsampled masks)."""
    ib = intermediate_bits(bpc)
    rnd = (32 << ib) + (0 if bpc == 8 else 8192) * 64
    mask_sh = bpc + ib - 4
    mask_rnd = 1 << (mask_sh - 5)
    m = jnp.minimum(38 + ((jnp.abs(tmp1 - tmp2) + mask_rnd) >> mask_sh), 64)
    out = (tmp1 * m + tmp2 * (64 - m) + rnd) >> (ib + 6)
    out = jnp.clip(out, 0, (1 << bpc) - 1)
    if ss_hor:
        mn = m[:, :, 0::2] + m[:, :, 1::2]
        if ss_ver:
            msk = (mn[:, 0::2, :] + mn[:, 1::2, :] + 2 - signs[:, None, None]) >> 2
        else:
            msk = (mn + 1 - signs[:, None, None]) >> 1
    else:
        msk = m
    return out, msk


@jax.jit
def blend_batch(a, b, msk):
    """mc.rs blend_rust:747: (N, h, w) blend of b over a by per-pixel mask."""
    m = msk.astype(jnp.int32)
    return (a * (64 - m) + b * m + 32) >> 6


def _obmc_masks():
    return jnp.asarray(np.asarray(OBMC_MASKS), jnp.int32)


@partial(jax.jit, static_argnums=(2,))
def blend_v_batch(a, b, w):
    """mc.rs blend_v_rust:771 (OBMC left-lap): blends the left 3w/4 columns
    of b over a; remaining columns pass through."""
    vw = (w * 3) >> 2
    m = jnp.concatenate(
        [_obmc_masks()[w : w + vw], jnp.zeros(w - vw, jnp.int32)]
    )[None, None, :]
    return (a * (64 - m) + b * m + 32) >> 6


@partial(jax.jit, static_argnums=(2,))
def blend_h_batch(a, b, h):
    """mc.rs blend_h_rust (OBMC top-lap): blends the top 3h/4 rows."""
    vh = (h * 3) >> 2
    m = jnp.concatenate(
        [_obmc_masks()[h : h + vh], jnp.zeros(h - vh, jnp.int32)]
    )[None, :, None]
    return (a * (64 - m) + b * m + 32) >> 6


@partial(jax.jit, static_argnums=(7, 8, 9, 12),
         static_argnames=("is_prep",))
def mc_8tap_scaled_batch(src, sys_, sxs, mxs, mys, dxs, dys, w, h, tmp_h,
                         vis_w, vis_h, bpc, f2ds=None, is_prep=False):
    """Batched put/prep_8tap_scaled (mc.rs :212/:351). mxs/mys are 10-bit
    subpel starts (< 1024), dxs/dys the 10-bit steps. Closed form of the
    reference's accumulator walk: at output column x the source offset is
    (mx + x*dx) >> 10 and the phase ((mx + x*dx) >> 6) & 15.
    tmp_h must statically bound ((h-1)*dy + my) >> 10) + 8."""
    F = jnp.asarray(np.asarray(MC_SUBPEL_FILTERS), jnp.int32)
    FD = jnp.asarray(np.asarray(FILTER_DIR), jnp.int32)[f2ds]
    ib = intermediate_bits(bpc)
    ird = (1 << ib) >> 1
    pxmax = (1 << bpc) - 1
    bias = 0 if bpc == 8 else 8192
    N = sys_.shape[0]

    xpos = mxs[:, None] + jnp.arange(w)[None, :] * dxs[:, None]  # (N, w)
    xcol = sxs[:, None] + (xpos >> 10)
    xphase = (xpos >> 6) & 15
    hi = jnp.where(w > 4, FD[:, 0], 3 + (FD[:, 0] & 1))
    fh = F[hi[:, None], xphase - 1]  # (N, w, 8)

    rows = jnp.clip(sys_[:, None] - 3 + jnp.arange(tmp_h)[None, :], 0, vis_h - 1)
    acc = jnp.zeros((N, tmp_h, w), jnp.int32)
    for k in range(8):
        cols = jnp.clip(xcol + k - 3, 0, vis_w - 1)
        px = src[rows[:, :, None], cols[:, None, :]].astype(jnp.int32)
        acc = acc + fh[:, None, :, k] * px
    sh = 6 - ib
    flt = (acc + ((1 << sh) >> 1)) >> sh
    base = jnp.clip(xcol, 0, vis_w - 1)
    raw = src[rows[:, :, None], base[:, None, :]].astype(jnp.int32) << ib
    mid = _i16(jnp.where((xphase != 0)[:, None, :], flt, raw))  # (N, tmp_h, w)

    ypos = mys[:, None] + jnp.arange(h)[None, :] * dys[:, None]  # (N, h)
    mrow = 3 + (ypos >> 10)
    yphase = (ypos >> 6) & 15
    vi = jnp.where(h > 4, FD[:, 1], 3 + (FD[:, 1] & 1))
    fv = F[vi[:, None], yphase - 1]  # (N, h, 8)
    vacc = jnp.zeros((N, h, w), jnp.int32)
    for k in range(8):
        ridx = jnp.clip(mrow + k - 3, 0, tmp_h - 1)
        mrows = jnp.take_along_axis(mid, ridx[:, :, None], axis=1)
        vacc = vacc + fv[:, :, k, None] * mrows
    center = jnp.take_along_axis(mid, jnp.clip(mrow, 0, tmp_h - 1)[:, :, None], axis=1)
    if is_prep:
        vflt = ((vacc + 32) >> 6) - bias
        vraw = center - bias
        return _i16(jnp.where((yphase != 0)[:, :, None], vflt, vraw))
    sh = 6 + ib
    vflt = jnp.clip((vacc + ((1 << sh) >> 1)) >> sh, 0, pxmax)
    vraw = jnp.clip((center + ird) >> ib, 0, pxmax)
    return jnp.where((yphase != 0)[:, :, None], vflt, vraw)


@partial(jax.jit, static_argnums=(7, 8, 9, 12),
         static_argnames=("is_prep",))
def bilin_scaled_batch(src, sys_, sxs, mxs, mys, dxs, dys, w, h, tmp_h,
                       vis_w, vis_h, bpc, is_prep=False):
    """Batched put/prep_bilin_scaled (mc.rs :496/:608). tmp_h statically
    bounds (((h-1)*dy + my) >> 10) + 2."""
    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1
    bias = 0 if bpc == 8 else 8192
    N = sys_.shape[0]

    xpos = mxs[:, None] + jnp.arange(w)[None, :] * dxs[:, None]
    xcol = sxs[:, None] + (xpos >> 10)
    fmx = (xpos >> 6) & 15
    rows = jnp.clip(sys_[:, None] + jnp.arange(tmp_h)[None, :], 0, vis_h - 1)
    c0 = jnp.clip(xcol, 0, vis_w - 1)
    c1 = jnp.clip(xcol + 1, 0, vis_w - 1)
    p0 = src[rows[:, :, None], c0[:, None, :]].astype(jnp.int32)
    p1 = src[rows[:, :, None], c1[:, None, :]].astype(jnp.int32)
    sh = 4 - ib
    mid = _i16((16 * p0 + fmx[:, None, :] * (p1 - p0) + ((1 << sh) >> 1)) >> sh)

    ypos = mys[:, None] + jnp.arange(h)[None, :] * dys[:, None]
    mrow = ypos >> 10
    fmy = ((ypos >> 6) & 15)[:, :, None]
    m0 = jnp.take_along_axis(mid, jnp.clip(mrow, 0, tmp_h - 1)[:, :, None], axis=1)
    m1 = jnp.take_along_axis(mid, jnp.clip(mrow + 1, 0, tmp_h - 1)[:, :, None], axis=1)
    v = 16 * m0 + fmy * (m1 - m0)
    if is_prep:
        return _i16(((v + 8) >> 4) - bias)
    sh = 4 + ib
    return jnp.clip((v + ((1 << sh) >> 1)) >> sh, 0, pxmax)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 6))
def resize_batch(src, h, dst_w, src_w, dx, mx0, bpc):
    """Horizontal 8-tap resample (superres; mc.rs resize_rust:1114) over a
    (h, >=src_w) plane slice -> (h, dst_w). Closed form of the reference's
    (mx, src_x) walk: src_x(x) = -1 + ((mx0 + x*dx) >> 14) - (mx0 >> 14)."""
    RF = jnp.asarray(np.asarray(RESIZE_FILTER), jnp.int32)
    pxmax = (1 << bpc) - 1
    pos = mx0 + jnp.arange(dst_w) * dx
    src_x = -1 + (pos >> 14) - (mx0 >> 14)
    filt = RF[(pos & 0x3FFF) >> 8]  # (dst_w, 8)
    acc = jnp.zeros((h, dst_w), jnp.int32)
    for k in range(8):
        cols = jnp.clip(src_x + k - 3, 0, src_w - 1)
        acc = acc + filt[None, :, k] * src[:h, cols].astype(jnp.int32)
    return jnp.clip((-acc + 64) >> 7, 0, pxmax)
