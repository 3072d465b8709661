"""Wavefront step kernels: one wave level of one size class as a traced
batch step (driven by engine/mega.py wave_prog's fori over wave levels).

Items are bucketed into two static size classes — S (tx <= 16x16) and
L (up to 64x64) — with per-wave slot capacity; descriptors are stacked
host-side into (NW, B, ...) arrays and uploaded once. Each scan step gathers
the items' edges from the current planes, predicts (traced-size kernels,
ops/dev/ipred_dyn.py), adds residuals, and scatters disjoint blocks back.

This replaces the per-(wave, size) dispatch model: dispatches drop from
O(waves x sizes) jit calls to O(1), and the XLA specialization key is only
(plane shape, bpc, feats, B, NW-bucket) — bounded per stream.

Parity: same oracle as the per-call path (src/recon.rs recon_b_intra order,
validated by tests/test_engine.py full-decode MD5s).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.dev import ipred_dyn as D
from .plan import (
    MODE_CFL_128,
    MODE_CFL_DC,
    MODE_CFL_LEFT,
    MODE_CFL_TOP,
    MODE_IDENT,
)
from ..syntax.levels import (
    DC_128_PRED,
    DC_PRED,
    FILTER_PRED,
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

CLS_S = (16, 16)
CLS_L = (64, 64)

_BASE_FNS = [
    (DC_PRED, D.dc_dyn),
    (VERT_PRED, D.v_dyn),
    (HOR_PRED, D.h_dyn),
    (LEFT_DC_PRED, D.dc_left_dyn),
    (TOP_DC_PRED, D.dc_top_dyn),
    (DC_128_PRED, D.dc_128_dyn),
    (SMOOTH_PRED, D.smooth_dyn),
    (SMOOTH_V_PRED, D.smooth_v_dyn),
    (SMOOTH_H_PRED, D.smooth_h_dyn),
    (PAETH_PRED, D.paeth_dyn),
]

_CFL_DC_FNS = {
    MODE_CFL_DC: D.dc_dyn,
    MODE_CFL_TOP: D.dc_top_dyn,
    MODE_CFL_LEFT: D.dc_left_dyn,
    MODE_CFL_128: D.dc_128_dyn,
}


def _class_step(pf, resid, d, CW, CH, bpc, feats, ss_hor, ss_ver, aw, psz,
                maskbuf=None, mask_base=0):
    """One wave step for one size class. maskbuf holds the interintra
    blend masks at word offset mask_base (0 when maskbuf is a dedicated
    array; the frame blob word offset in engine v3)."""
    C = 2 * CH
    w = d["w"]
    h = d["h"]
    coords = _build_coords(d, CW, CH, aw, psz, bpc)
    edge = jnp.where(
        coords < 0, -coords - 1, pf[jnp.clip(coords, 0, pf.shape[0] - 1)]
    )
    modes = d["modes"]
    angles = d["angles"]
    m3 = modes[:, None, None]
    pxmax = (1 << bpc) - 1

    # every mode kernel runs on the whole batch and a select keeps each
    # item's own mode (the selects are elementwise)
    out = D.dc_dyn(edge, C, CW, CH, w, h, bpc)
    for code, fn in _BASE_FNS[1:]:
        out = jnp.where(m3 == code, fn(edge, C, CW, CH, w, h, bpc), out)
    # rare/expensive features run under lax.cond on host-packed per-wave
    # presence flags: a wave without (say) FILTER_PRED never executes its
    # sequential sub-block scan
    wflags = d.get("wflags")
    flags = wflags[0] if wflags is not None else None

    def gated(bit, fn, out):
        if flags is None:
            return fn(out)
        return jax.lax.cond(flags & bit != 0, fn, lambda o: o, out)

    if "z" in feats:
        def with_z(out):
            o = jnp.where(
                m3 == Z1_PRED,
                D.z1_dyn(edge, C, CW, CH, w, h, bpc, angles), out,
            )
            o = jnp.where(
                m3 == Z2_PRED,
                D.z2_dyn(edge, C, CW, CH, w, h, bpc, angles,
                             d["z2mw"], d["z2mh"], d["z2sm"]),
                o,
            )
            return jnp.where(
                m3 == Z3_PRED,
                D.z3_dyn(edge, C, CW, CH, w, h, bpc, angles), o,
            )

        out = gated(F_Z, with_z, out)
    if "filter" in feats:
        def with_filter(out):
            return jnp.where(
                m3 == FILTER_PRED,
                D.filter_dyn(edge, C, CW, CH, w, h, bpc, angles),
                out,
            )

        out = gated(F_FILTER, with_filter, out)

    dy = jnp.arange(CH)[None, :, None] * aw
    dx = jnp.arange(CW)[None, None, :]
    idx = d["flat0"][:, None, None] + dy + dx

    if "ident" in feats:
        def with_ident(out):
            own = pf[jnp.clip(idx, 0, pf.shape[0] - 1)]
            return jnp.where(m3 == MODE_IDENT, own, out)

        out = gated(F_IDENT, with_ident, out)
    if "cfl" in feats:
        def with_cfl(out):
            ldy = jnp.arange(CH << ss_ver)[None, :, None] * aw
            ldx = jnp.arange(CW << ss_hor)[None, None, :]
            lidx = d["cfl0"][:, None, None] + ldy + ldx
            ypx = pf[jnp.clip(lidx, 0, pf.shape[0] - 1)]
            ac = D.cfl_ac_dyn(ypx, CW, CH, w, h, ss_hor, ss_ver,
                                  d["cflwp"], d["cflhp"])
            for code, fn in _CFL_DC_FNS.items():
                dc = fn(edge, C, CW, CH, w, h, bpc)[:, 0, 0]
                pred = D.cfl_pred_dyn(dc, ac, d["cfla"], bpc)
                out = jnp.where(m3 == code, pred, out)
            return out

        out = gated(F_CFL, with_cfl, out)

    if "ii" in feats:
        def with_ii(out):
            # interintra: blend the intra prediction over the block's
            # inter pixels by the mask table (recon.rs recon_b_inter)
            own = pf[jnp.clip(idx, 0, pf.shape[0] - 1)]
            moff = d["iioff"]
            dyl = jnp.arange(CH)[None, :, None]
            dxl = jnp.arange(CW)[None, None, :]
            # masks packed at class-width stride (inter.py _ii_mask_flat):
            # constant stride keeps this an affine (fast) gather
            midx = mask_base + moff[:, None, None] + dyl * CW + dxl
            m = maskbuf[jnp.clip(midx, 0, maskbuf.shape[0] - 1)]
            blended = (own * (64 - m) + out * m + 32) >> 6
            return jnp.where((moff >= 0)[:, None, None], blended, out)

        out = gated(F_II, with_ii, out)

    res = resid[jnp.clip(idx, 0, resid.shape[0] - 1)]
    out = jnp.where(
        d["rmask"][:, None, None], jnp.clip(out + res, 0, pxmax), out
    )
    mask = (jnp.arange(CW)[None, None, :] < w[:, None, None]) & (
        jnp.arange(CH)[None, :, None] < h[:, None, None]
    )
    idx = jnp.where(mask, idx, 3 * psz)
    return pf.at[idx].set(out, mode="drop")


# blob layout: one int32 row per item = [coords(EL) | scalar fields];
# a single upload per class per frame instead of one per field.
# `wflags`/`wcount` are per-WAVE values stored on lane 0: the feature
# presence bitmask and the filled item count, read by the device step to
# lax.cond-skip expensive rare features (filter intra's sequential scan,
# the z gathers, cfl, interintra) on waves that do not contain them.
FIELDS = ("modes", "angles", "flat0", "rmask", "z2mw", "z2mh", "z2sm",
          "cfla", "cfl0", "cflwp", "cflhp", "w", "h", "iioff",
          "wflags", "wcount",
          "hav", "phl", "phbl", "pht", "phtr")
N_FIELDS = len(FIELDS)

# wflags bits
F_Z = 1
F_FILTER = 2
F_CFL = 4
F_IDENT = 8
F_II = 16


def _unpack_blob(blob, EL=0):
    d = {}
    for i, k in enumerate(FIELDS):
        v = blob[:, EL + i]
        d[k] = (v != 0) if k in ("rmask", "z2sm") else v
    return d


def _build_coords(d, CW, CH, aw, psz, bpc):
    """Reconstruct the prepare_intra_edges index plan (B, 2CH+1+2CW) from
    the parametric descriptor (plan.plan_edges): availability bits +
    per-strip available-pixel counts. Replaces the host-serialized
    per-item coord vectors (65-257 words/item — the bulk of keyframe
    blobs) with ~5 scalars; all index math is elementwise iota arithmetic
    on device. Encoding matches the old plan: value >= 0 is a flat plane
    index, value < 0 decodes to the constant -(v)-1
    (src/ipred_prepare.rs:118 availability/replication rules)."""
    flat0 = d["flat0"]
    rem = flat0 % psz
    plbase = flat0 - rem
    py = rem // aw
    px = rem % aw
    have_l = (d["hav"] & 1) != 0
    have_t = (d["hav"] & 2) != 0
    phl, phbl = d["phl"], d["phbl"]
    pht, phtr = d["pht"], d["phtr"]
    w = d["w"]
    h = d["h"]
    half = (1 << bpc) >> 1
    constL = -(half + 1 + 1)   # left fill constant, encoded -(c+1)
    constT = -(half - 1 + 1)   # top fill constant
    constC = -(half + 1)       # corner constant

    top0 = plbase + (py - 1) * aw + px - jnp.where(have_l, 1, 0)
    leftpix = plbase + py * aw + (px - 1)
    left_fill = jnp.where(have_t, top0, constL)            # (B,)
    top_fill = jnp.where(have_l, leftpix, constT)
    corner = jnp.where(have_t, top0,
                       jnp.where(have_l, leftpix, constC))

    colbase = plbase + (px - 1)

    def left_at(i):
        # i (B, K): left strip value at strip index i (with replication)
        return jnp.where(
            have_l[:, None],
            colbase[:, None] + (py[:, None]
                                + jnp.minimum(i, phl[:, None] - 1)) * aw,
            left_fill[:, None],
        )

    j = jnp.arange(2 * CH)[None, :]
    k = 2 * CH - 1 - j  # combined below-strip index for vector position j
    hh = h[:, None]
    lval = left_at(k)
    l_last = left_at(hh - 1)
    bl_repl = colbase[:, None] + (
        py[:, None] + hh + jnp.minimum(k - hh, phbl[:, None] - 1)
    ) * aw
    blval = jnp.where(phbl[:, None] > 0, bl_repl, l_last)
    bottom = jnp.where(k < hh, lval, jnp.where(k < 2 * hh, blval, -1))

    rowbase = plbase + (py - 1) * aw + px

    def top_at(i):
        return jnp.where(
            have_t[:, None],
            rowbase[:, None] + jnp.minimum(i, pht[:, None] - 1),
            top_fill[:, None],
        )

    j2 = jnp.arange(2 * CW)[None, :]
    ww = w[:, None]
    tval = top_at(j2)
    t_last = top_at(ww - 1)
    tr_repl = rowbase[:, None] + ww + jnp.minimum(
        j2 - ww, phtr[:, None] - 1
    )
    trval = jnp.where(phtr[:, None] > 0, tr_repl, t_last)
    top = jnp.where(j2 < ww, tval, jnp.where(j2 < 2 * ww, trval, -1))

    return jnp.concatenate([bottom, corner[:, None], top], axis=1)
