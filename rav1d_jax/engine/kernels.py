"""Engine v2 fixed-key kernels.

Every distinct shape or static argument is one more XLA compilation. The
round-2 engine paid one jit key per (w, h, txtp, subpel-case, batch-pow2)
combination — 1,800+ compilations for one 320x240 stream. These kernels
bound the key space instead:

- itx: ONE kernel per (w, h, bpc): the tx type becomes data. All 1-D
  variants valid for the size (dct/adst/flipadst/identity) are computed and
  selected per lane with jnp.where — elementwise compute is cheap, keys
  are not. Batches run in fixed-size chunks so the batch length never enters
  the key (role parity: the itxfm_add[19][17] fn-ptr table,
  src/itx.rs:194, collapsed into data-driven dispatch).
- mc/warp/compound (tiles.py + this module): every block decomposes into
  8x8 destination tiles against a device-resident reference plane stack;
  one kernel per (phase case, plane kind, bpc).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.ref import itx as R
from ..ops.dev.itx import _Lanes, _apply_1d
from ..syntax.levels import WHT_WHT

# 1-D variant order; per-block codes index into this
VARIANTS = ("dct", "adst", "flipadst", "identity")
_VCODE = {name: i for i, name in enumerate(VARIANTS)}

# txtp -> (first_code, second_code); WHT handled separately
TXTP_FIRST = np.zeros(17, np.int32)
TXTP_SECOND = np.zeros(17, np.int32)
for _tp, (_f, _s) in R._TXTP_1D.items():
    TXTP_FIRST[_tp] = _VCODE[_f]
    TXTP_SECOND[_tp] = _VCODE[_s]


def _variants_for(n):
    """1-D variants AV1 allows at size n (adst families stop at 16)."""
    if n <= 16:
        return VARIANTS
    if n == 32:
        return ("dct", "identity")
    return ("dct",)


def _sel_pass(vals_in, variants, codes, n, mn, mx):
    """Run every 1-D variant over the lane list and select per batch lane.
    vals_in: list of n arrays (N, L); codes: (N,) variant codes."""
    outs = []
    for name in variants:
        lanes = _Lanes(list(vals_in))
        _apply_1d(name, n, lanes, mn, mx)
        outs.append([lanes.vals[i] for i in range(n)])
    if len(variants) == 1:
        return outs[0]
    sel = []
    c = codes[:, None]
    for i in range(n):
        v = outs[0][i]
        for k, name in enumerate(variants[1:], start=1):
            v = jnp.where(c == _VCODE[name], outs[k][i], v)
        sel.append(v)
    return sel


def itx_any_core(cb, firstv, secondv, w, h, bpc):
    """Inverse-transform a batch with per-block tx types.

    cb: (N, sh, sw) int32 coefficients in natural (y, x) order;
    firstv/secondv: (N,) VARIANTS codes. Returns (N, h, w) int32 residuals.
    Semantics identical to ops.dev.itx.itx_core per block
    (src/itx.rs inv_txfm_add_rust:64)."""
    shift = R._SHIFTS[(w, h)]
    is_rect2 = w * 2 == h or h * 2 == w
    rnd = (1 << shift) >> 1
    sh = min(h, 32)
    sw = min(w, 32)
    if bpc == 8:
        row_clip_min = col_clip_min = -(1 << 15)
    else:
        bitdepth_max = (1 << bpc) - 1
        row_clip_min = (~bitdepth_max) << 7
        col_clip_min = (~bitdepth_max) << 5
    row_clip_max = ~row_clip_min
    col_clip_max = ~col_clip_min

    cb = cb.astype(jnp.int32)
    if is_rect2:
        cb = (cb * 181 + 128) >> 8

    zeros = jnp.zeros((cb.shape[0], sh), jnp.int32)
    vals = [cb[:, :, x] if x < sw else zeros for x in range(w)]
    vals = _sel_pass(vals, _variants_for(w), firstv, w,
                     row_clip_min, row_clip_max)
    mid = jnp.stack(vals, axis=2)  # (N, sh, w)
    mid = ((mid + rnd) >> shift).clip(col_clip_min, col_clip_max)

    zeros2 = jnp.zeros((cb.shape[0], w), jnp.int32)
    vals = [mid[:, y, :] if y < sh else zeros2 for y in range(h)]
    vals = _sel_pass(vals, _variants_for(h), secondv, h,
                     col_clip_min, col_clip_max)
    res = jnp.stack(vals, axis=1)  # (N, h, w)
    return (res + 8) >> 4


def wht_core(cb):
    """4x4 Walsh-Hadamard (lossless; src/itx_1d.rs inv_wht4_1d).
    cb: (N, 4, 4) int32. Returns (N, 4, 4) int32 residuals (added as-is)."""
    t = cb >> 2

    def wht4(l0, l1, l2, l3):
        t0 = l0 + l1
        t2 = l2 - l3
        t4 = (t0 - t2) >> 1
        t3 = t4 - l3
        t1 = t4 - l1
        return t0 - t3, t3, t1, t2 + t1

    # rows (transform over x), then columns (over y)
    r = [t[:, :, i] for i in range(4)]
    r = wht4(*r)
    m = jnp.stack(r, axis=2)
    c = [m[:, i, :] for i in range(4)]
    c = wht4(*c)
    return jnp.stack(c, axis=1)


def chunk_for(w, h):
    """Fixed chunk size per tx size: the batch length never enters the jit
    key; chunks keep per-dispatch work roughly even."""
    b = 16384 // (w * h)
    p = 32
    while p < b:
        p <<= 1
    return min(p, 1024)
