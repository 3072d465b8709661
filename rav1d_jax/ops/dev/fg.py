"""Film grain application on the device (jax.numpy, jit-compiled).

The pixel-rate half of fgy_32x32xn (src/filmgrain.rs): per-pixel scaling
LUT lookup, grain multiply with rounding, and range clipping — batched over
all 32x32 grain blocks of a frame. The sequential parts (per-block PRNG
offset chain, AR-filter grain LUT generation, 2-px overlap blending) stay
host-side; they touch O(blocks) data while this kernel does the O(pixels)
work. Parity: ops/ref/fg.py fgy noise math, the film-grain parity tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnums=(3, 4, 5))
def fg_blend_batch(src, grain, scaling, scaling_shift, min_value, max_value):
    """src: (N, h, w) int32 pixels; grain: (N, h, w) int32 (post-overlap);
    scaling: (1<<bpc,) int32 LUT. Returns clipped noisy pixels."""
    sc = scaling[src]
    rnd = (1 << scaling_shift) >> 1
    noise = (sc * grain + rnd) >> scaling_shift
    return jnp.clip(src + noise, min_value, max_value)
