"""Batched inverse transforms on the device (jax.numpy, jit-compiled).

Reuses the exact integer butterfly kernels from ops.ref.itx (they are
written against a generic array protocol: operators + ``.clip``), driving
them with jax arrays through a lane adapter. One jit specialization per
(w, h, txtp, bpc); the batch dimension N maps onto the vector lanes.

This is the dense-plane half of the two-plane design (DESIGN.md): the
entropy plane emits per-size batches of dequantized coefficient blocks;
this module turns them into residuals, vectorized across every block in
a frame at once.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ref import itx as R


class _Lanes:
    """List-of-arrays view with numpy-slice semantics over the lane axis.

    The ref 1-D kernels index/assign single lanes and recurse on strided
    slices (``c[::2]``); this adapter maps those accesses onto a shared
    Python list of immutable jax arrays.
    """

    __slots__ = ("vals", "idx")

    def __init__(self, vals, idx=None):
        self.vals = vals
        self.idx = list(range(len(vals))) if idx is None else idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return _Lanes(self.vals, self.idx[i])
        return self.vals[self.idx[i]]

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            for j, vv in zip(self.idx[i], v):
                self.vals[j] = vv
            return
        self.vals[self.idx[i]] = v


def _apply_1d(name, n, lanes, mn, mx):
    if name == "identity":
        if n == 4:
            for i in range(4):
                lanes[i] = lanes[i] + ((lanes[i] * 1697 + 2048) >> 12)
        elif n == 8:
            for i in range(8):
                lanes[i] = lanes[i] * 2
        elif n == 16:
            for i in range(16):
                lanes[i] = 2 * lanes[i] + ((lanes[i] * 1697 + 1024) >> 11)
        else:
            for i in range(32):
                lanes[i] = lanes[i] * 4
        return
    R._FAMILY[name][n](lanes, mn, mx)


def itx_core(coeff, w, h, txtp, bpc):
    """Inverse-transform a batch of coefficient blocks into residuals.

    coeff: (N, sh, sw) int32 dequantized coefficients in natural (y, x)
    order (sh/sw = min(h/w, 32)). Returns (N, h, w) int32 residuals (the
    reference's final `(acc + 8) >> 4` values, before the pixel add).
    Traceable: composes into larger jitted phases (the engine's residual
    scatter) as well as the jitted itx_add_batch wrapper below.
    """
    first_name, second_name = R._TXTP_1D[txtp]
    shift = R._SHIFTS[(w, h)]
    is_rect2 = w * 2 == h or h * 2 == w
    rnd = (1 << shift) >> 1
    pixel_max = (1 << bpc) - 1
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

    cb = coeff.astype(jnp.int32)
    if is_rect2:
        cb = (cb * 181 + 128) >> 8

    # row pass: lanes over x (w points), each lane (N, sh)
    zeros = jnp.zeros((cb.shape[0], sh), dtype=jnp.int32)
    lanes = _Lanes([cb[:, :, x] if x < sw else zeros for x in range(w)])
    _apply_1d(first_name, w, lanes, row_clip_min, row_clip_max)
    mid = jnp.stack([lanes.vals[x] for x in range(w)], axis=2)  # (N, sh, w)
    mid = ((mid + rnd) >> shift).clip(col_clip_min, col_clip_max)

    # column pass: lanes over y (h points), each lane (N, w)
    zeros2 = jnp.zeros((cb.shape[0], w), dtype=jnp.int32)
    lanes = _Lanes([mid[:, y, :] if y < sh else zeros2 for y in range(h)])
    _apply_1d(second_name, h, lanes, col_clip_min, col_clip_max)
    res = jnp.stack([lanes.vals[y] for y in range(h)], axis=1)  # (N, h, w)
    return (res + 8) >> 4


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def itx_add_batch(dst, coeff, w, h, txtp, bpc):
    """Inverse-transform a batch of blocks and add into pixel blocks.
    Parity: ops.ref.itx.inv_txfm_add per block."""
    pixel_max = (1 << bpc) - 1
    res = itx_core(coeff, w, h, txtp, bpc)
    return (dst + res).clip(0, pixel_max)
