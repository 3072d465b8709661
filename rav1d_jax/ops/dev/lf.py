"""Deblocking filter on the device (jax.numpy, jit-compiled).

Same mask-driven batched formulation as the CPU executor
(ops/ref/lf.py filter_lines_batch): all 4-px edge segments of one width
class are filtered as (N, 16) pixel lines in one shot — AV1 guarantees
edges within a direction pass never overlap, so the batch is bit-exact.
Parity: src/loopfilter.rs loop_filter scalar semantics, validated against
the numpy executor in the deblock parity tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnums=(4, 5))
def filter_lines_batch(px, E, I, H, wd, bpc):
    """px: (N, 16) int32 lines (px[:, 8] = q0); E/I/H: (N,) 8-bit-scale
    thresholds; wd static filter width (4/6/8/16). Returns filtered lines."""
    px = px.astype(jnp.int32)
    off = 8
    bd_min8 = bpc - 8
    F = 1 << bd_min8
    pixel_max = (1 << bpc) - 1
    E = E.astype(jnp.int32) << bd_min8
    I = I.astype(jnp.int32) << bd_min8
    H = H.astype(jnp.int32) << bd_min8

    p1, p0 = px[:, off - 2], px[:, off - 1]
    q0, q1 = px[:, off], px[:, off + 1]
    fm = (
        (jnp.abs(p1 - p0) <= I)
        & (jnp.abs(q1 - q0) <= I)
        & (jnp.abs(p0 - q0) * 2 + (jnp.abs(p1 - q1) >> 1) <= E)
    )
    zero = jnp.zeros_like(p0)
    p2 = p3 = q2 = q3 = zero
    if wd > 4:
        p2, q2 = px[:, off - 3], px[:, off + 2]
        fm &= (jnp.abs(p2 - p1) <= I) & (jnp.abs(q2 - q1) <= I)
        if wd > 6:
            p3, q3 = px[:, off - 4], px[:, off + 3]
            fm &= (jnp.abs(p3 - p2) <= I) & (jnp.abs(q3 - q2) <= I)
    out = px

    flat8in = jnp.zeros_like(fm)
    if wd >= 6:
        flat8in = (
            (jnp.abs(p2 - p0) <= F)
            & (jnp.abs(p1 - p0) <= F)
            & (jnp.abs(q1 - q0) <= F)
            & (jnp.abs(q2 - q0) <= F)
        )
    if wd >= 8:
        flat8in &= (jnp.abs(p3 - p0) <= F) & (jnp.abs(q3 - q0) <= F)

    if wd >= 16:
        p6, p5, p4 = px[:, off - 7], px[:, off - 6], px[:, off - 5]
        q4, q5, q6 = px[:, off + 4], px[:, off + 5], px[:, off + 6]
        flat8out = (
            (jnp.abs(p6 - p0) <= F)
            & (jnp.abs(p5 - p0) <= F)
            & (jnp.abs(p4 - p0) <= F)
            & (jnp.abs(q4 - q0) <= F)
            & (jnp.abs(q5 - q0) <= F)
            & (jnp.abs(q6 - q0) <= F)
        )
        m16 = fm & flat8out & flat8in
        vals = [
            (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4,
            (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4,
            (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4,
            (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4,
            (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4,
            (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4,
            (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4,
            (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4,
            (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4,
            (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8) >> 4,
            (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4,
            (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4,
        ]
        for k, v in enumerate(vals):
            c = off - 6 + k
            out = out.at[:, c].set(jnp.where(m16, v, out[:, c]))
        narrow = fm & ~(flat8out & flat8in)
    else:
        narrow = fm

    if wd >= 8:
        m8 = narrow & flat8in
        vals = [
            (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3,
            (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3,
            (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
            (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
            (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3,
            (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3,
        ]
        for k, v in enumerate(vals):
            c = off - 3 + k
            out = out.at[:, c].set(jnp.where(m8, v, out[:, c]))
        narrow = narrow & ~flat8in
    elif wd == 6:
        m6 = narrow & flat8in
        vals = [
            (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3,
            (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
            (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
            (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3,
        ]
        for k, v in enumerate(vals):
            c = off - 2 + k
            out = out.at[:, c].set(jnp.where(m6, v, out[:, c]))
        narrow = narrow & ~flat8in

    hev = (jnp.abs(p1 - p0) > H) | (jnp.abs(q1 - q0) > H)
    lim_lo = -128 << bd_min8
    lim_hi = (128 << bd_min8) - 1

    def clipd(v):
        return jnp.clip(v, lim_lo, lim_hi)

    fv_h = clipd(3 * (q0 - p0) + clipd(p1 - q1))
    fv_n = clipd(3 * (q0 - p0))
    fv = jnp.where(hev, fv_h, fv_n)
    f1 = jnp.minimum(fv + 4, lim_hi) >> 3
    f2 = jnp.minimum(fv + 3, lim_hi) >> 3
    np0 = jnp.clip(p0 + f2, 0, pixel_max)
    nq0 = jnp.clip(q0 - f1, 0, pixel_max)
    fv2 = (f1 + 1) >> 1
    np1 = jnp.where(hev, p1, jnp.clip(p1 + fv2, 0, pixel_max))
    nq1 = jnp.where(hev, q1, jnp.clip(q1 - fv2, 0, pixel_max))
    out = out.at[:, off - 2].set(jnp.where(narrow, np1, out[:, off - 2]))
    out = out.at[:, off - 1].set(jnp.where(narrow, np0, out[:, off - 1]))
    out = out.at[:, off + 0].set(jnp.where(narrow, nq0, out[:, off + 0]))
    out = out.at[:, off + 1].set(jnp.where(narrow, nq1, out[:, off + 1]))
    return out
