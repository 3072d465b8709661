"""Engine v3: the whole dense pass as FOUR jitted device programs.

Round-3's engine issued hundreds of eager dispatches + `view()` slices per
frame; at the measured ~0.1-1.4 ms per dependent dispatch that was a ~1-2 s
floor per frame before any math ran. v3 collapses the pass into

    resid_prog  -> inter_prog -> wave_prog -> filter_prog

with ALL per-frame variability expressed as *data*: descriptor chunks live
in the single uploaded frame blob (engine/blob2.py) and every program walks
them with `lax.fori_loop` + `lax.dynamic_slice` at offsets read from the
blob's header region. Nothing about descriptor counts, placement, or
feature presence enters an XLA compile key — the static key is only
(frame geometry, bitdepth, layout, blob capacity bucket), so a stream
compiles each program once and never again.

Role parity: this is the analog of rav1d's one-call-per-module DSP layer
(src/internal.rs:112-121) + the recon replay pass (src/recon.rs:2402,:3162)
+ the filter_sbrow chain (src/recon.rs:4047-4338), fused per frame.

Header layout (word indices into the blob; see run2.py packers):
  R0 + 2*si          itx chunk region (base, count) per tx size class
  WHT0               lossless WHT 4x4 chunk region
  CF0                coefficient region base (int16-packed for 8 bpc)
  PAL0               palette scatter chunks (base, count)
  WAVE0              n_waves, S rows base, L rows base, ii-mask base
  INTER0 + 2*slot    inter tile-descriptor chunk regions per static slot
  IH0                inter mask region base, w_avg weight region base
  DB0                deblock: eih base + 6 packed class|level map bases
  CDEF0              cdef: y level map base, uv level map base, damping
  SR0                superres dx/mx0 per plane pair
  LR0 + 2*slot       loop-restoration stripe chunk regions per slot
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.ref.itx import _SHIFTS
from .kernels import chunk_for, itx_any_core, wht_core
from .plan import CAP, CLS_L, CLS_S
from .tiles import (
    D_BH, D_BW, D_F2D, D_FLAT0, D_MX, D_MY, D_SROW, D_SX, D_SY, D_TH, D_TW,
    W_A, W_B, W_C, W_D, W_FLAT0, W_MX, W_MY, W_SROW, W_SX, W_SY, W_TH, W_TW,
    C_FLAT0, C_P0, C_P1, C_P2, C_R0, C_R1, C_TH, C_TW,
    B_FLAT0, B_MCS, B_MOFF, B_MRS, B_ROW, B_TH, B_TW,
    _filters, _gather, _i16,
)
from .wave2 import FIELDS, N_FIELDS, _class_step, _unpack_blob

# ------------------------------- header ----------------------------------

HDR_LEN = 512
SIZES = sorted(_SHIFTS.keys())  # 19 (w, h) itx size classes
R0 = 8
WHT0 = R0 + 2 * len(SIZES)
CF0 = WHT0 + 2
PAL0 = CF0 + 1
WAVE0 = PAL0 + 2
INTER0 = WAVE0 + 4

SLOTS = {
    "putY": 0, "putC": 1, "lapY": 2, "lapC": 3,
    "warpY": 4, "warpC": 5,
    "prepY": 6, "prepC": 7, "wprepY": 8, "wprepC": 9,
    "hostpool": 10,
    "avg": 11, "segy00": 12, "segy10": 13, "segy11": 14,
    "mask": 15, "seguv": 16, "blend": 17,
}
N_SLOTS = 18
IH0 = INTER0 + 2 * N_SLOTS  # inter hmask region base
DB0 = IH0 + 1               # eih base + 6 pass map bases
CDEF0 = DB0 + 7             # ylvl base, uvlvl base, damping
SR0 = CDEF0 + 3             # dx0, mx00, dx1, mx01
LR0 = SR0 + 4               # 12 x (base, count): kind {w,0,1,2} x plane
assert LR0 + 24 <= HDR_LEN

# chunk geometry (static; trip counts are traced so these never key)
PAL_B = 1024      # palette (idx, val) pairs per chunk
TB = 256          # inter tiles per chunk
NPUT = 12         # put descriptor rows: tiles.NPUT + bilin flag row
NWARP = 12
NCOMB = 8
NBLEND = 7
HB = 64           # host-pool tiles per chunk
LRB = 64          # LR stripes per chunk
WHT_B = 256

WAVE_FEATS = ("cfl", "filter", "ident", "ii", "z")


def _u8_region(dev, base, n):
    """Read n packed bytes starting at word `base` (static n)."""
    wds = jax.lax.dynamic_slice(dev, (base,), ((n + 3) // 4,))
    b = jnp.stack(
        [wds & 255, (wds >> 8) & 255, (wds >> 16) & 255, (wds >> 24) & 255],
        axis=-1,
    ).reshape(-1)
    return b[:n]


# ------------------------------ residuals --------------------------------


@partial(jax.jit, static_argnames=("ah", "aw", "bpc"))
def resid_prog(dev, *, ah, aw, bpc):
    """Inverse-transform every coefficient block of the frame into the
    residual buffer: [0, 3psz) wavefront-phase blocks, [3psz, 6psz)
    batch-phase (inter) blocks. Also returns the zeroed frame planes."""
    psz = ah * aw
    ra = jnp.zeros(6 * psz, jnp.int32)
    cf_base = dev[CF0]

    for si, (w, h) in enumerate(SIZES):
        B = chunk_for(w, h)
        sh_, sw_ = min(h, 32), min(w, 32)
        M = sh_ * sw_
        stride = 4 * B
        base = dev[R0 + 2 * si]
        n = dev[R0 + 2 * si + 1]

        def body(i, ra, base=base, B=B, w=w, h=h, M=M, stride=stride,
                 sh_=sh_, sw_=sw_):
            d = jax.lax.dynamic_slice(dev, (base + i * stride,), (stride,))
            offs, flat0 = d[:B], d[B : 2 * B]
            f0, f1 = d[2 * B : 3 * B], d[3 * B :]
            if bpc == 8:
                wds = dev[
                    cf_base + (offs[:, None] >> 1)
                    + jnp.arange(M // 2)[None, :]
                ]
                cfs = (
                    jax.lax.bitcast_convert_type(wds, jnp.int16)
                    .reshape(B, M)
                    .astype(jnp.int32)
                )
            else:
                cfs = dev[cf_base + offs[:, None] + jnp.arange(M)[None, :]]
            cb = cfs.reshape(B, sw_, sh_).transpose(0, 2, 1)
            res = itx_any_core(cb, f0, f1, w, h, bpc)
            idx = (
                flat0[:, None, None]
                + jnp.arange(h)[None, :, None] * aw
                + jnp.arange(w)[None, None, :]
            )
            return ra.at[idx].set(res, mode="drop")

        ra = jax.lax.fori_loop(0, n, body, ra)

    # lossless WHT 4x4 (src/itx_1d.rs inv_wht4_1d)
    wbase = dev[WHT0]
    wn = dev[WHT0 + 1]

    def wbody(i, ra):
        d = jax.lax.dynamic_slice(dev, (wbase + i * 2 * WHT_B,), (2 * WHT_B,))
        offs, flat0 = d[:WHT_B], d[WHT_B:]
        if bpc == 8:
            wds = dev[cf_base + (offs[:, None] >> 1) + jnp.arange(8)[None, :]]
            cfs = (
                jax.lax.bitcast_convert_type(wds, jnp.int16)
                .reshape(WHT_B, 16)
                .astype(jnp.int32)
            )
        else:
            cfs = dev[cf_base + offs[:, None] + jnp.arange(16)[None, :]]
        cb = cfs.reshape(WHT_B, 4, 4).transpose(0, 2, 1)
        res = wht_core(cb)
        idx = (
            flat0[:, None, None]
            + jnp.arange(4)[None, :, None] * aw
            + jnp.arange(4)[None, None, :]
        )
        return ra.at[idx].set(res, mode="drop")

    ra = jax.lax.fori_loop(0, wn, wbody, ra)
    planes = jnp.zeros((3, ah, aw), jnp.int32)
    return ra, planes


# ------------------------------ wavefront --------------------------------


@partial(
    jax.jit,
    static_argnames=("ah", "aw", "bpc", "ss_hor", "ss_ver"),
    donate_argnames=("planes",),
)
def wave_prog(planes, ra, dev, *, ah, aw, bpc, ss_hor, ss_ver):
    """Palette scatters then the full intra wavefront as one traced loop
    over wave levels (recon_b_intra order; src/recon.rs:2402)."""
    psz = ah * aw
    pf = planes.reshape(-1)
    resid = ra[: 3 * psz]

    pbase = dev[PAL0]
    pn = dev[PAL0 + 1]

    def pbody(i, pf):
        d = jax.lax.dynamic_slice(dev, (pbase + i * 2 * PAL_B,), (2 * PAL_B,))
        return pf.at[d[:PAL_B]].set(d[PAL_B:], mode="drop")

    pf = jax.lax.fori_loop(0, pn, pbody, pf)

    nw = dev[WAVE0]
    sbase = dev[WAVE0 + 1]
    lbase = dev[WAVE0 + 2]
    mask_base = dev[WAVE0 + 3]
    SS = CAP[0] * N_FIELDS
    LS = CAP[1] * N_FIELDS

    def body(i, pf):
        # each class step is skipped entirely (lax.cond) on waves with no
        # items of that class — wcount packed on lane 0 by run2._pack_class
        sb = jax.lax.dynamic_slice(dev, (sbase + i * SS,), (SS,)).reshape(
            CAP[0], N_FIELDS
        )
        d = _unpack_blob(sb)
        pf = jax.lax.cond(
            d["wcount"][0] > 0,
            lambda pf, d=d: _class_step(pf, resid, d, CLS_S[0], CLS_S[1],
                                        bpc, WAVE_FEATS, ss_hor, ss_ver, aw,
                                        psz, dev, mask_base),
            lambda pf: pf,
            pf,
        )
        lb = jax.lax.dynamic_slice(dev, (lbase + i * LS,), (LS,)).reshape(
            CAP[1], N_FIELDS
        )
        d = _unpack_blob(lb)
        pf = jax.lax.cond(
            d["wcount"][0] > 0,
            lambda pf, d=d: _class_step(pf, resid, d, CLS_L[0], CLS_L[1],
                                        bpc, WAVE_FEATS, ss_hor, ss_ver, aw,
                                        psz, dev, mask_base),
            lambda pf: pf,
            pf,
        )
        return pf

    pf = jax.lax.fori_loop(0, nw, body, pf)
    return pf.reshape(3, ah, aw)


# -------------------------------- inter ----------------------------------


def _slot(dev, name):
    return dev[INTER0 + 2 * SLOTS[name]], dev[INTER0 + 2 * SLOTS[name] + 1]


def _chunks(dev, name, rows, body, state):
    """Run `body(state, d)` over every (rows, TB) descriptor chunk of a
    slot; trip count and placement are traced data."""
    base, n = _slot(dev, name)
    stride = rows * TB

    def it(i, state):
        d = jax.lax.dynamic_slice(dev, (base + i * stride,), (stride,))
        return body(state, d.reshape(rows, TB))

    return jax.lax.fori_loop(0, n, it, state)


def _put_out(stack, d, vw, vh, bpc):
    """One put tile chunk. Chunks are case-pure (descriptor row 11 = case,
    set host-side by run2.add_put): 0 = 8-tap h+v, 1 = h only, 2 = v only,
    3 = copy, 4 = bilinear — lax.switch runs ONLY that case's gather +
    filter (put_8tap_rust:130 / put_bilin_rust:431). The old select-of-
    all-variants form computed ~5x the needed work per tile."""
    from ..ops.ref.mc import intermediate_bits

    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1
    sh = 6 - ib

    def mk_filters():
        dd = [d[r] for r in range(11)]
        dd[D_MX] = jnp.maximum(d[D_MX], 1)
        dd[D_MY] = jnp.maximum(d[D_MY], 1)
        return _filters(dd, None, None)

    def case_hv():
        win = _gather(stack, d[D_SROW], d[D_SY] - 3, 15, d[D_SX] - 3, 15,
                      vw, vh)
        fh, fv = mk_filters()
        mid = jnp.zeros((win.shape[0], 15, 8), jnp.int32)
        for k in range(8):
            mid = mid + fh[:, k, None, None] * win[:, :, k : k + 8]
        mid = _i16((mid + ((1 << sh) >> 1)) >> sh)
        hv = jnp.zeros((win.shape[0], 8, 8), jnp.int32)
        for k in range(8):
            hv = hv + fv[:, k, None, None] * mid[:, k : k + 8, :]
        sh2 = 6 + ib
        return jnp.clip((hv + ((1 << sh2) >> 1)) >> sh2, 0, pxmax)

    def case_h():
        win = _gather(stack, d[D_SROW], d[D_SY], 8, d[D_SX] - 3, 15, vw, vh)
        fh, _ = mk_filters()
        ho = jnp.zeros((win.shape[0], 8, 8), jnp.int32)
        for k in range(8):
            ho = ho + fh[:, k, None, None] * win[:, :, k : k + 8]
        return jnp.clip((ho + 32 + ((1 << sh) >> 1)) >> 6, 0, pxmax)

    def case_v():
        win = _gather(stack, d[D_SROW], d[D_SY] - 3, 15, d[D_SX], 8, vw, vh)
        _, fv = mk_filters()
        vo = jnp.zeros((win.shape[0], 8, 8), jnp.int32)
        for k in range(8):
            vo = vo + fv[:, k, None, None] * win[:, k : k + 8, :]
        return jnp.clip((vo + 32) >> 6, 0, pxmax)

    def case_cp():
        return _gather(stack, d[D_SROW], d[D_SY], 8, d[D_SX], 8, vw, vh)

    def case_bilin():
        b = _gather(stack, d[D_SROW], d[D_SY], 9, d[D_SX], 9, vw, vh)
        mx = d[D_MX][:, None, None]
        my = d[D_MY][:, None, None]
        sh_h = 4 - ib
        hrnd = (1 << sh_h) >> 1
        hsrc = b[:, :, :8]
        hf = 16 * hsrc + mx * (b[:, :, 1:9] - hsrc)
        mid_f = _i16((hf + hrnd) >> sh_h)
        vf_f = (16 * mid_f[:, :8, :]
                + my * (mid_f[:, 1:9, :] - mid_f[:, :8, :]))
        vf_r = 16 * hsrc[:, :8, :] + my * (hsrc[:, 1:9, :] - hsrc[:, :8, :])
        sh_v = 4 + ib
        ird = (1 << ib) >> 1
        outb = jnp.where(
            my != 0,
            jnp.where(mx != 0, (vf_f + ((1 << sh_v) >> 1)) >> sh_v,
                      (vf_r + 8) >> 4),
            jnp.where(mx != 0, (mid_f[:, :8, :] + ird) >> ib,
                      hsrc[:, :8, :]),
        )
        return jnp.clip(outb, 0, pxmax)

    return jax.lax.switch(
        jnp.clip(d[11][0], 0, 4),
        [case_hv, case_h, case_v, case_cp, case_bilin],
    )


def _prep_out(stack, d, vw, vh, bpc):
    """8-tap prep, case-pure chunks like _put_out (prep_8tap_rust:277):
    descriptor row 11 = case 0 h+v / 1 h / 2 v / 3 copy."""
    from ..ops.ref.mc import intermediate_bits

    ib = intermediate_bits(bpc)
    bias = 0 if bpc == 8 else 8192
    sh = 6 - ib

    def mk_filters():
        dd = [d[r] for r in range(11)]
        dd[D_MX] = jnp.maximum(d[D_MX], 1)
        dd[D_MY] = jnp.maximum(d[D_MY], 1)
        return _filters(dd, None, None)

    def case_hv():
        win = _gather(stack, d[D_SROW], d[D_SY] - 3, 15, d[D_SX] - 3, 15,
                      vw, vh)
        fh, fv = mk_filters()
        mid = jnp.zeros((win.shape[0], 15, 8), jnp.int32)
        for k in range(8):
            mid = mid + fh[:, k, None, None] * win[:, :, k : k + 8]
        mid = _i16((mid + ((1 << sh) >> 1)) >> sh)
        hv = jnp.zeros((win.shape[0], 8, 8), jnp.int32)
        for k in range(8):
            hv = hv + fv[:, k, None, None] * mid[:, k : k + 8, :]
        return ((hv + 32) >> 6) - bias

    def case_h():
        win = _gather(stack, d[D_SROW], d[D_SY], 8, d[D_SX] - 3, 15, vw, vh)
        fh, _ = mk_filters()
        ho = jnp.zeros((win.shape[0], 8, 8), jnp.int32)
        for k in range(8):
            ho = ho + fh[:, k, None, None] * win[:, :, k : k + 8]
        return ((ho + ((1 << sh) >> 1)) >> sh) - bias

    def case_v():
        win = _gather(stack, d[D_SROW], d[D_SY] - 3, 15, d[D_SX], 8, vw, vh)
        _, fv = mk_filters()
        vo = jnp.zeros((win.shape[0], 8, 8), jnp.int32)
        for k in range(8):
            vo = vo + fv[:, k, None, None] * win[:, k : k + 8, :]
        return ((vo + ((1 << sh) >> 1)) >> sh) - bias

    def case_cp():
        win = _gather(stack, d[D_SROW], d[D_SY], 8, d[D_SX], 8, vw, vh)
        return (win << ib) - bias

    return _i16(jax.lax.switch(
        jnp.clip(d[11][0], 0, 3),
        [case_hv, case_h, case_v, case_cp],
    ))


def _warp_out(stack, d, vw, vh, bpc):
    from ..ops.ref.mc import intermediate_bits
    from ..tables.spec_data import MC_WARP_FILTER

    F = jnp.asarray(np.asarray(MC_WARP_FILTER), jnp.int32)
    ib = intermediate_bits(bpc)
    region = _gather(stack, d[W_SROW], d[W_SY] - 3, 15, d[W_SX] - 3, 15,
                     vw, vh)
    ys = jnp.arange(15)[None, :, None]
    xs = jnp.arange(8)[None, None, :]
    tmx = (d[W_MX][:, None, None] + ys * d[W_B][:, None, None]
           + xs * d[W_A][:, None, None])
    taps = F[64 + ((tmx + 512) >> 10)]
    sh = 7 - ib
    mid = jnp.zeros(region.shape[:2] + (8,), jnp.int32)
    for k in range(8):
        mid = mid + taps[:, :, :, k] * region[:, :, k : k + 8]
    mid = _i16((mid + ((1 << sh) >> 1)) >> sh)
    ys8 = jnp.arange(8)[None, :, None]
    tmy = (d[W_MY][:, None, None] + ys8 * d[W_D][:, None, None]
           + xs * d[W_C][:, None, None])
    vtaps = F[64 + ((tmy + 512) >> 10)]
    v = jnp.zeros((region.shape[0], 8, 8), jnp.int32)
    for k in range(8):
        v = v + vtaps[:, :, :, k] * mid[:, k : k + 8, :]
    return v


def _scatter8(buf, out, flat0, tw, th, stride):
    r = jnp.arange(8)
    idx = flat0[:, None, None] + r[None, :, None] * stride + r[None, None, :]
    valid = (r[None, :, None] < th[:, None, None]) & (
        r[None, None, :] < tw[:, None, None]
    )
    big = jnp.iinfo(jnp.int32).max
    return buf.at[jnp.where(valid, idx, big)].set(out, mode="drop")


@partial(
    jax.jit,
    static_argnames=("ah", "aw", "bpc", "vwY", "vhY", "vwC", "vhC"),
    donate_argnames=("planes",),
)
def inter_prog(planes, ra, dev, stackY, stackC, *, ah, aw, bpc, vwY, vhY,
               vwC, vhC):
    """The frame's whole inter phase: puts/warps into the planes, preps
    into the compound pool, compound combines, OBMC lap blends, then the
    fused batch residual add (recon_b_inter:3162 and mc.rs combiners)."""
    from ..ops.ref.mc import intermediate_bits

    psz = ah * aw
    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1
    pf = planes.reshape(-1)

    POOLROWS = (6 * psz) // 64
    pool = jnp.zeros((POOLROWS, 8, 8), jnp.int32)
    lappool = jnp.zeros((POOLROWS, 8, 8), jnp.int32)
    maskpool = jnp.zeros(psz, jnp.int32)
    hbase = dev[IH0]

    sY = stackY.astype(jnp.int32)
    sC = stackC.astype(jnp.int32)

    # 1. puts into the planes / the OBMC lap pool
    for name, stack, vw, vh, to_lap in (
        ("putY", sY, vwY, vhY, False),
        ("putC", sC, vwC, vhC, False),
        ("lapY", sY, vwY, vhY, True),
        ("lapC", sC, vwC, vhC, True),
    ):
        def body(state, d, stack=stack, vw=vw, vh=vh, to_lap=to_lap):
            out = _put_out(stack, d, vw, vh, bpc)
            if to_lap:
                lapf = state.reshape(-1)
                lapf = _scatter8(lapf, out, d[D_FLAT0], d[D_TW], d[D_TH], 8)
                return lapf.reshape(POOLROWS, 8, 8)
            return _scatter8(state, out, d[D_FLAT0], d[D_TW], d[D_TH], aw)

        if to_lap:
            lappool = _chunks(dev, name, NPUT, body, lappool)
        else:
            pf = _chunks(dev, name, NPUT, body, pf)

    # 2. warp puts
    for name, stack, vw, vh in (("warpY", sY, vwY, vhY),
                                ("warpC", sC, vwC, vhC)):
        def body(pf, d, stack=stack, vw=vw, vh=vh):
            v = _warp_out(stack, d, vw, vh, bpc)
            sh = 7 + ib
            out = jnp.clip((v + ((1 << sh) >> 1)) >> sh, 0, pxmax)
            return _scatter8(pf, out, d[W_FLAT0], d[W_TW], d[W_TH], aw)

        pf = _chunks(dev, name, NWARP, body, pf)

    # 3. compound preps into the pool
    for name, stack, vw, vh in (("prepY", sY, vwY, vhY),
                                ("prepC", sC, vwC, vhC)):
        def body(pool, d, stack=stack, vw=vw, vh=vh):
            out = _prep_out(stack, d, vw, vh, bpc)
            poolf = pool.reshape(-1)
            poolf = _scatter8(poolf, out, d[D_FLAT0], d[D_TW], d[D_TH], 8)
            return poolf.reshape(POOLROWS, 8, 8)

        pool = _chunks(dev, name, NPUT, body, pool)

    for name, stack, vw, vh in (("wprepY", sY, vwY, vhY),
                                ("wprepC", sC, vwC, vhC)):
        def body(pool, d, stack=stack, vw=vw, vh=vh):
            v = _warp_out(stack, d, vw, vh, bpc)
            bias = 0 if bpc == 8 else 8192
            out = _i16(((v + 64) >> 7) - bias)
            poolf = pool.reshape(-1)
            poolf = _scatter8(poolf, out, d[W_FLAT0], d[W_TW], d[W_TH], 8)
            return poolf.reshape(POOLROWS, 8, 8)

        pool = _chunks(dev, name, NWARP, body, pool)

    # host-computed prep tiles (rare bilinear compounds): chunk layout is
    # HB row ids then HB 8x8 int32 tiles
    def hbody(pool, d):
        rows = d[0]
        tiles = d[1:].T.reshape(HB, 8, 8)
        return pool.at[rows].set(tiles, mode="drop")

    base, n = _slot(dev, "hostpool")

    def hit(i, pool):
        stride = HB * 65
        d = jax.lax.dynamic_slice(dev, (base + i * stride,), (stride,))
        return hbody(pool, d.reshape(65, HB))

    pool = jax.lax.fori_loop(0, n, hit, pool)

    # 4. compound combines
    rnd_avg = (8 << ib) + (0 if bpc == 8 else 8192) * 16
    rnd_msk = (32 << ib) + (0 if bpc == 8 else 8192) * 64

    def avg_body(pf, d):
        t1 = pool[d[C_R0]]
        t2 = pool[d[C_R1]]
        wt = d[C_P0][:, None, None]
        out = (t1 * wt + t2 * (16 - wt) + rnd_avg) >> (ib + 4)
        return _scatter8(pf, jnp.clip(out, 0, pxmax), d[C_FLAT0], d[C_TW],
                         d[C_TH], aw)

    pf = _chunks(dev, "avg", NCOMB, avg_body, pf)

    mask_sh = bpc + ib - 4
    mask_rnd = 1 << (mask_sh - 5)
    for name, sh_, sv_ in (("segy00", 0, 0), ("segy10", 1, 0),
                           ("segy11", 1, 1)):
        def body(state, d, sh_=sh_, sv_=sv_):
            pf, maskpool = state
            t1 = pool[d[C_R0]]
            t2 = pool[d[C_R1]]
            m = jnp.minimum(38 + ((jnp.abs(t1 - t2) + mask_rnd) >> mask_sh),
                            64)
            out = (t1 * m + t2 * (64 - m) + rnd_msk) >> (ib + 6)
            pf = _scatter8(pf, jnp.clip(out, 0, pxmax), d[C_FLAT0], d[C_TW],
                           d[C_TH], aw)
            signs = d[C_P2][:, None, None]
            if sh_:
                mn = m[:, :, 0::2] + m[:, :, 1::2]
                if sv_:
                    msk = (mn[:, 0::2, :] + mn[:, 1::2, :] + 2 - signs) >> 2
                else:
                    msk = (mn + 1 - signs) >> 1
            else:
                msk = m
            mh, mw = 8 >> sv_, 8 >> sh_
            r = jnp.arange(mh)
            c = jnp.arange(mw)
            midx = (d[C_P0][:, None, None]
                    + r[None, :, None] * d[C_P1][:, None, None]
                    + c[None, None, :])
            valid = (
                r[None, :, None] < ((d[C_TH][:, None, None] + sv_) >> sv_)
            ) & (c[None, None, :] < ((d[C_TW][:, None, None] + sh_) >> sh_))
            big = jnp.iinfo(jnp.int32).max
            maskpool = maskpool.at[jnp.where(valid, midx, big)].set(
                msk, mode="drop"
            )
            return pf, maskpool

        pf, maskpool = _chunks(dev, name, NCOMB, body, (pf, maskpool))

    def mask_body(pf, d):
        """Wedge/interintra-style masked combine; mask bytes gather from
        the blob's mask region."""
        t1 = pool[d[C_R0]]
        t2 = pool[d[C_R1]]
        r = jnp.arange(8)
        midx = (hbase + d[C_P0][:, None, None]
                + r[None, :, None] * d[C_P1][:, None, None]
                + r[None, None, :])
        m = dev[jnp.clip(midx, 0, dev.shape[0] - 1)]
        out = (t1 * m + t2 * (64 - m) + rnd_msk) >> (ib + 6)
        return _scatter8(pf, jnp.clip(out, 0, pxmax), d[C_FLAT0], d[C_TW],
                         d[C_TH], aw)

    pf = _chunks(dev, "mask", NCOMB, mask_body, pf)

    def seguv_body(pf, d):
        t1 = pool[d[C_R0]]
        t2 = pool[d[C_R1]]
        r = jnp.arange(8)
        midx = (d[C_P0][:, None, None]
                + r[None, :, None] * d[C_P1][:, None, None]
                + r[None, None, :])
        m = maskpool[jnp.clip(midx, 0, psz - 1)]
        out = (t1 * m + t2 * (64 - m) + rnd_msk) >> (ib + 6)
        return _scatter8(pf, jnp.clip(out, 0, pxmax), d[C_FLAT0], d[C_TW],
                         d[C_TH], aw)

    pf = _chunks(dev, "seguv", NCOMB, seguv_body, pf)

    # 5. OBMC lap blends (top laps packed before left laps in the slot;
    # fori order preserves the blend sequence — recon.rs obmc ordering)
    def blend_body(pf, d):
        r = jnp.arange(8)
        idx = (d[B_FLAT0][:, None, None] + r[None, :, None] * aw
               + r[None, None, :])
        a = pf[jnp.clip(idx, 0, pf.shape[0] - 1)]
        b = lappool[d[B_ROW]]
        midx = (hbase + d[B_MOFF][:, None, None]
                + r[None, :, None] * d[B_MRS][:, None, None]
                + r[None, None, :] * d[B_MCS][:, None, None])
        m = dev[jnp.clip(midx, 0, dev.shape[0] - 1)]
        out = (a * (64 - m) + b * m + 32) >> 6
        valid = (r[None, :, None] < d[B_TH][:, None, None]) & (
            r[None, None, :] < d[B_TW][:, None, None]
        )
        big = jnp.iinfo(jnp.int32).max
        return pf.at[jnp.where(valid, idx, big)].set(out, mode="drop")

    pf = _chunks(dev, "blend", NBLEND, blend_body, pf)

    # 6. fused batch residual add (batch-phase tx blocks live in ra's
    # second half; zero elsewhere so clip is the identity)
    planes = pf.reshape(3, ah, aw)
    rb = ra[3 * psz : 6 * psz].reshape(3, ah, aw)
    return jnp.clip(planes + rb, 0, pxmax)


# ------------------------------- filters ---------------------------------


@partial(
    jax.jit,
    static_argnames=(
        "geom", "bpc", "layout_i", "need_sr", "sr_geom", "lr_ws",
    ),
    donate_argnames=("planes",),
)
def filter_prog(planes, dev, *, geom, bpc, layout_i, need_sr, sr_geom,
                lr_ws):
    """Deblock -> CDEF -> superres -> loop restoration -> packed output.
    geom = (ah, aw, ach, acw, bh, bw, cur_h); layout_i = PixelLayout int;
    sr_geom = (s_ah, s_aw, sr_w, sr_h, srcw_y) or None;
    lr_ws = (Wy, Wc) static LR max unit widths.
    Returns (uint planes for the ref twins, packed output bytes)."""
    from .filters import (
        cdef_pass_raw, lf_dir_pass_raw, lr_sgr_pass_raw, lr_wiener_pass_raw,
        resize_plane_raw,
    )

    ah, aw, ach, acw, bh, bw, cur_h = geom
    ss_hor = 0 if layout_i == 3 else 1
    ss_ver = 1 if layout_i == 1 else 0
    has_chroma = layout_i != 0
    h4, w4 = bh, bw
    ch4 = (bh + ss_ver) >> ss_ver
    cw4 = (bw + ss_hor) >> ss_hor

    # ---- deblock: 6 passes, byte-packed class|level maps (zero level =
    # no-op, so absent deblock costs only the reads) ----
    eih = jax.lax.dynamic_slice(dev, (dev[DB0],), (128,)).reshape(2, 64)

    def db(pl_idx, pass_i, nh4, nw4, luma, hor, planes):
        n = nh4 * nw4
        b = _u8_region(dev, dev[DB0 + 1 + pass_i], n)
        cm = (b >> 6).reshape(nh4, nw4)
        lv = (b & 63).reshape(nh4, nw4)
        return planes.at[pl_idx].set(
            lf_dir_pass_raw(planes[pl_idx], cm, lv, eih, luma, hor, bpc)
        )

    # maps are stored post-transpose for horizontal passes (host resolve)
    planes = db(0, 0, h4, w4, True, False, planes)
    if has_chroma:
        planes = db(1, 1, ch4, cw4, False, False, planes)
        planes = db(2, 2, ch4, cw4, False, False, planes)
    planes = db(0, 3, w4, h4, True, True, planes)
    if has_chroma:
        planes = db(1, 4, cw4, ch4, False, True, planes)
        planes = db(2, 5, cw4, ch4, False, True, planes)

    pre_cdef = planes  # post-deblock snapshot for LR's lpf lines

    # ---- cdef: level maps as bytes; strengths derived on device ----
    nby, nbx = (bh + 1) >> 1, (bw + 1) >> 1
    bdm8 = bpc - 8
    ylvl = _u8_region(dev, dev[CDEF0], nby * nbx).reshape(nby, nbx)
    uvlvl = _u8_region(dev, dev[CDEF0 + 1], nby * nbx).reshape(nby, nbx)
    damping = dev[CDEF0 + 2]
    y_pri = (ylvl >> 2) << bdm8
    y_sec = ylvl & 3
    y_sec = jnp.where(y_sec == 3, 4, y_sec) << bdm8
    uv_pri = (uvlvl >> 2) << bdm8
    uv_sec = uvlvl & 3
    uv_sec = jnp.where(uv_sec == 3, 4, uv_sec) << bdm8
    maps = jnp.stack([y_pri, y_sec, uvlvl, uv_pri, uv_sec])
    uv422 = -1 if layout_i == 0 else (1 if layout_i == 2 else 0)
    planes = cdef_pass_raw(planes, maps, damping, nby, nbx, bh, bw, ss_hor,
                           ss_ver, uv422, bpc)

    # ---- superres (static geometry switch) ----
    if need_sr:
        s_ah, s_aw, sr_w, sr_h, srcw_y = sr_geom
        outs = []
        pres = []
        for pl in range(3):
            if pl and not has_chroma:
                outs.append(jnp.zeros((s_ah, s_aw), jnp.int32))
                pres.append(jnp.zeros((s_ah, s_aw), jnp.int32))
                continue
            sh = ss_hor if pl else 0
            sv = ss_ver if pl else 0
            ci = 1 if pl else 0
            dst_w = (sr_w + sh) >> sh
            src_w = (srcw_y + sh) >> sh
            h = (cur_h + sv) >> sv
            dx = dev[SR0 + 2 * ci]
            mx0 = dev[SR0 + 2 * ci + 1]
            args = (h, dst_w, src_w, dx, mx0, bpc, s_aw)
            outs.append(jnp.pad(
                resize_plane_raw(planes[pl], *args), ((0, s_ah - h), (0, 0))
            ))
            pres.append(jnp.pad(
                resize_plane_raw(pre_cdef[pl], *args),
                ((0, s_ah - h), (0, 0)),
            ))
        planes = jnp.stack(outs)
        pre_cdef = jnp.stack(pres)
        ah, aw = s_ah, s_aw
        out_w, out_h = sr_w, sr_h
    else:
        out_w, out_h = None, None  # visible dims handled by pack slices

    # ---- loop restoration: 12 static slots, stripes as data ----
    Wy, Wc = lr_ws
    vis_h = (cur_h if not need_sr else sr_h)
    lr_outs = []
    for pl in range(3):
        if pl and not has_chroma:
            lr_outs.append(planes[pl])
            continue
        sv = ss_ver if pl else 0
        ph = (vis_h + sv) >> sv
        W = Wc if pl else Wy
        plane = planes[pl]
        cat = jnp.concatenate([plane[:ph], pre_cdef[pl][:ph]])
        pfl = plane.reshape(-1)
        for ki, kind in enumerate(("w", 0, 1, 2)):
            base = dev[LR0 + 2 * (4 * pl + ki)]
            n = dev[LR0 + 2 * (4 * pl + ki) + 1]
            stride = 16 * LRB

            def it(i, pfl, base=base, kind=kind, W=W, cat=cat):
                d = jax.lax.dynamic_slice(
                    dev, (base + i * stride,), (stride,)
                ).reshape(16, LRB)
                if kind == "w":
                    return lr_wiener_pass_raw(pfl, cat, d, W, bpc, aw)
                return lr_sgr_pass_raw(pfl, cat, d, W, kind, bpc, aw)

            pfl = jax.lax.fori_loop(0, n, it, pfl)
        lr_outs.append(pfl.reshape(plane.shape))
    # one stack instead of three .at[pl].set full-array copies (the
    # copies alone profiled 12 ms/frame at 320p)
    planes = jnp.stack(lr_outs)

    # ---- pack the output (the only device->host payload) ----
    odt = jnp.uint8 if bpc == 8 else jnp.uint16
    y = planes[0].reshape(-1)
    if has_chroma:
        u = planes[1][:ach, :acw].reshape(-1)
        v = planes[2][:ach, :acw].reshape(-1)
        packed = jnp.concatenate([y, u, v]).astype(odt)
    else:
        packed = y.astype(odt)
    return planes.astype(odt), packed
