"""CDEF on the device: direction search + constrained filter, batched over all
8x8 blocks of a frame (jax.numpy, jit).

Same integer semantics as ops.ref.cdef; formulated as fixed shifted-window
gathers over a padded per-block tile so every block filters in parallel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...tables.spec_data import CDEF_DIRECTIONS

MISSING = -32768


def _off(o):
    o = int(o)
    dy = (o + 6) // 12
    return dy, o - dy * 12


# precomputed (dy, dx) offset tables per direction for the 3 tap rings
_PRI_OFF = [[_off(CDEF_DIRECTIONS[d + 2][k]) for k in range(2)] for d in range(8)]
_SEC1_OFF = [[_off(CDEF_DIRECTIONS[d + 4][k]) for k in range(2)] for d in range(8)]
_SEC2_OFF = [[_off(CDEF_DIRECTIONS[d + 0][k]) for k in range(2)] for d in range(8)]

_FD_PROJ = None


def _fd_projections():
    """One-hot scatter matrices (64, nbins) for the 8 partial-sum axes."""
    global _FD_PROJ
    if _FD_PROJ is None:
        ys, xs = np.mgrid[0:8, 0:8]
        idxs = [
            ((ys + xs).ravel(), 15),
            ((ys + (xs >> 1)).ravel(), 11),
            (ys.ravel(), 8),
            ((3 + ys - (xs >> 1)).ravel(), 11),
            ((7 + ys - xs).ravel(), 15),
            ((3 - (ys >> 1) + xs).ravel(), 11),
            (xs.ravel(), 8),
            (((ys >> 1) + xs).ravel(), 11),
        ]
        _FD_PROJ = [np.eye(nb, dtype=np.int32)[ix] for ix, nb in idxs]
    return _FD_PROJ


@partial(jax.jit, static_argnums=(1,))
def find_dir_batch(blocks, bpc):
    """blocks: (N, 8, 8) int32. Returns (dir (N,), var (N,)) — parity with
    ops.ref.cdef.find_dir per block."""
    bdm8 = bpc - 8
    px = ((blocks.astype(jnp.int32) >> bdm8) - 128).reshape(-1, 64)
    proj = _fd_projections()
    sums = [px @ p for p in proj]  # per-axis partial sums
    d0, a0, h0, a1, d1, a2, h1, a3 = sums
    M = jnp.uint32(0xFFFFFFFF)

    def u32(x):
        return x.astype(jnp.uint32)

    div_table = jnp.asarray([840, 420, 280, 210, 168, 140, 120], dtype=jnp.int32)
    cost = [None] * 8
    cost[2] = u32((h0.astype(jnp.int32) ** 2).sum(axis=1) * 105)
    cost[6] = u32((h1.astype(jnp.int32) ** 2).sum(axis=1) * 105)
    for ci, dd in ((0, d0), (4, d1)):
        d64 = dd.astype(jnp.int32)
        v = ((d64[:, :7] ** 2 + d64[:, 14:7:-1] ** 2) * div_table[None, :]).sum(axis=1)
        v = v + d64[:, 7] ** 2 * 105
        cost[ci] = u32(v)
    for n, aa in ((0, a0), (1, a1), (2, a2), (3, a3)):
        a64 = aa.astype(jnp.int32)
        c = (a64[:, 3:8] ** 2).sum(axis=1) * 105
        c = c + (
            (a64[:, :3] ** 2 + a64[:, 10:7:-1] ** 2)
            * div_table[jnp.asarray([1, 3, 5])][None, :]
        ).sum(axis=1)
        cost[n * 2 + 1] = u32(c)
    costs = jnp.stack(cost, axis=1)  # (N, 8) uint32
    best_dir = jnp.argmax(costs, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(costs, best_dir[:, None], axis=1)[:, 0]
    alt = jnp.take_along_axis(costs, (best_dir ^ 4)[:, None], axis=1)[:, 0]
    var = ((best - alt) & M) >> 10
    return best_dir, var.astype(jnp.int32)


def _constrain(diff, threshold, shift):
    adiff = jnp.abs(diff)
    v = jnp.minimum(adiff, jnp.maximum(0, threshold - (adiff >> shift)))
    return jnp.where(diff < 0, -v, v)


def _ulog2_arr(v):
    # bit_length - 1 for v >= 1
    return (31 - jax.lax.clz(v.astype(jnp.int32))).astype(jnp.int32)


@partial(jax.jit, static_argnums=(5,))
def cdef_filter_batch(tiles, pri, sec, direction, damping, bpc):
    """Filter a batch of padded CDEF tiles.

    tiles: (N, h+4, w+4) int32, pre-padded with MISSING where edges are
    unavailable (the 2px ring). pri/sec/direction: (N,) int32 per-block
    params (0 strength = skip that stage). damping: (N,) int32.
    Returns (N, h, w) filtered pixels. Parity: cdef_filter_block_c.
    """
    h = tiles.shape[1] - 4
    w = tiles.shape[2] - 4
    bdm8 = bpc - 8

    px = tiles[:, 2 : 2 + h, 2 : 2 + w]
    pri_tap = 4 - ((pri >> bdm8) & 1)
    pri_shift = jnp.maximum(0, damping - jnp.where(pri > 0, _ulog2_arr(jnp.maximum(pri, 1)), 0))
    sec_shift = damping - jnp.where(sec > 0, _ulog2_arr(jnp.maximum(sec, 1)), 0)

    def win(offsets):
        """Gather (N, h, w) for per-block direction-dependent offsets.

        offsets: python list of 8 (dy, dx) pairs per direction; select by
        the per-block direction via jnp.choose over stacked shifts.
        """
        alld = jnp.stack(
            [tiles[:, 2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w] for dy, dx in offsets],
            axis=0,
        )  # (8, N, h, w)
        return jnp.take_along_axis(
            alld, direction[None, :, None, None], axis=0
        )[0]

    pv = pri[:, None, None]
    sv = sec[:, None, None]
    psh = pri_shift[:, None, None]
    ssh = sec_shift[:, None, None]

    s = jnp.zeros_like(px)
    mn = px
    mx = px

    def track(mn, mx, v):
        uv = v.astype(jnp.uint32)
        return (
            jnp.where(uv < mn.astype(jnp.uint32), v, mn),
            jnp.maximum(v, mx),
        )

    have_sec = sv > 0
    have_pri = pv > 0
    tap = pri_tap[:, None, None]
    for k in range(2):
        p0 = win([_PRI_OFF[d][k] for d in range(8)])
        p1 = win([(-dy, -dx) for dy, dx in [_PRI_OFF[d][k] for d in range(8)]])
        contrib = tap * (
            _constrain(p0 - px, pv, psh) + _constrain(p1 - px, pv, psh)
        )
        s = s + jnp.where(have_pri, contrib, 0)
        mn, mx = track(mn, mx, jnp.where(have_pri & have_sec, p0, px))
        mn, mx = track(mn, mx, jnp.where(have_pri & have_sec, p1, px))
        tap = (tap & 3) | 2

        s0 = win([_SEC1_OFF[d][k] for d in range(8)])
        s1 = win([(-dy, -dx) for dy, dx in [_SEC1_OFF[d][k] for d in range(8)]])
        s2 = win([_SEC2_OFF[d][k] for d in range(8)])
        s3 = win([(-dy, -dx) for dy, dx in [_SEC2_OFF[d][k] for d in range(8)]])
        sec_tap = 2 - k
        contrib = sec_tap * (
            _constrain(s0 - px, sv, ssh)
            + _constrain(s1 - px, sv, ssh)
            + _constrain(s2 - px, sv, ssh)
            + _constrain(s3 - px, sv, ssh)
        )
        s = s + jnp.where(have_sec, contrib, 0)
        for svv in (s0, s1, s2, s3):
            mn, mx = track(mn, mx, jnp.where(have_pri & have_sec, svv, px))

    out = px + ((s - (s < 0) + 8) >> 4)
    # clamp to [mn, mx] only when both stages ran (reference behavior)
    clamped = jnp.maximum(mn, jnp.minimum(out, mx))
    out = jnp.where(have_pri & have_sec, clamped, out)
    return jnp.where(have_pri | have_sec, out, px)
