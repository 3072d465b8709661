"""Parity: device film-grain blend vs the reference fgy noise math."""

import numpy as np
import pytest


@pytest.mark.parametrize("bpc", [8, 10])
def test_fg_blend_batch_parity(bpc):
    from rav1d_jax.ops.dev.fg import fg_blend_batch

    rng = np.random.default_rng(bpc)
    N, h, w = 6, 32, 32
    mx = (1 << bpc) - 1
    src = rng.integers(0, mx, (N, h, w)).astype(np.int32)
    grain_ctr = 128 << (bpc - 8)
    grain = rng.integers(-grain_ctr, grain_ctr, (N, h, w)).astype(np.int32)
    scaling = rng.integers(0, 256, (1 << bpc,)).astype(np.int32)
    shift = 8

    # reference math (ops/ref/fg.py fgy_32x32xn noise step)
    sc = scaling[src].astype(np.int64)
    noise = (sc * grain + ((1 << shift) >> 1)) >> shift
    want = np.clip(src + noise, 16 << (bpc - 8), 235 << (bpc - 8))

    got = np.asarray(
        fg_blend_batch(src, grain, scaling, shift, 16 << (bpc - 8), 235 << (bpc - 8))
    )
    np.testing.assert_array_equal(got, want)
