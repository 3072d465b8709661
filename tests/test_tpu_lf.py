"""checkasm-style parity: device (jax) deblock lines vs numpy executor."""

import numpy as np
import pytest

from rav1d_jax.ops.ref.lf import filter_lines_batch as ref_filter


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("wd", [4, 6, 8, 16])
def test_deblock_lines_parity(bpc, wd):
    from rav1d_jax.ops.dev.lf import filter_lines_batch as dev_filter

    rng = np.random.default_rng(wd * 31 + bpc)
    N = 257
    mx = (1 << bpc) - 1
    # half fully random, half near-flat (to hit the flat8 branches)
    px = rng.integers(0, mx, (N, 16)).astype(np.int32)
    base = rng.integers(0, mx, (N // 2, 1))
    px[: N // 2] = base + rng.integers(-2, 3, (N // 2, 16))
    px = np.clip(px, 0, mx)
    L = rng.integers(1, 64, N).astype(np.int32)
    E = (2 * (L + 2) + np.minimum(L, 9)).astype(np.int32)
    I = np.maximum(L >> 1, 1).astype(np.int32)
    H = (L >> 4).astype(np.int32)

    want = ref_filter(px, E, I, H, wd, bpc)
    got = np.asarray(dev_filter(px, E, I, H, wd, bpc))
    np.testing.assert_array_equal(got, want)
