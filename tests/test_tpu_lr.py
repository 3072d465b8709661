"""checkasm-style parity: device (jax) Wiener restoration vs numpy reference."""

import numpy as np
import pytest

from rav1d_jax.ops.ref.lr import wiener as ref_wiener


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("w,h", [(256, 64), (64, 33), (96, 16)])
def test_wiener_batch_parity(bpc, w, h):
    from rav1d_jax.ops.dev.lr import wiener_batch

    rng = np.random.default_rng(w + h + bpc)
    N = 5
    mx = (1 << bpc) - 1
    tmps = rng.integers(0, mx, (N, h + 6, w + 6)).astype(np.int32)
    fhs = rng.integers(-16, 16, (N, 3)).astype(np.int32)
    fvs = rng.integers(-16, 16, (N, 3)).astype(np.int32)

    want = np.zeros((N, h, w), dtype=np.int32)
    for i in range(N):
        dst = np.zeros((h, w), dtype=np.int32)
        ref_wiener(dst, 0, 0, tmps[i], w, h, list(fhs[i]), list(fvs[i]), bpc)
        want[i] = dst
    got = np.asarray(wiener_batch(tmps, fhs, fvs, w, h, bpc))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_sgr_batch_parity(bpc, kind):
    from rav1d_jax.ops.ref.lr import sgr as ref_sgr
    from rav1d_jax.ops.dev.lr import sgr_batch
    from rav1d_jax.tables.spec_data import SGR_PARAMS

    rng = np.random.default_rng(bpc * 3 + kind)
    # sgr_idx choices per kind: 5x5-only (s1==0), 3x3-only (s0==0), mix
    idxs_by_kind = {
        0: [i for i in range(16) if SGR_PARAMS[i][0] and not SGR_PARAMS[i][1]],
        1: [i for i in range(16) if not SGR_PARAMS[i][0] and SGR_PARAMS[i][1]],
        2: [i for i in range(16) if SGR_PARAMS[i][0] and SGR_PARAMS[i][1]],
    }
    N, w, h = 5, 32, 16
    tmps = rng.integers(0, (1 << bpc) - 1, (N, h + 6, w + 6)).astype(np.int32)
    cur = rng.integers(0, (1 << bpc) - 1, (N, h, w)).astype(np.int32)
    sgr_idxs = rng.choice(idxs_by_kind[kind], N)
    wts = rng.integers(-96, 32, (N, 2))

    want = []
    for i in range(N):
        dst = cur[i].copy()
        ref_sgr(dst, 0, 0, tmps[i], w, h, int(sgr_idxs[i]),
                [int(wts[i, 0]), int(wts[i, 1])], bpc)
        want.append(dst)
    s0s = np.asarray([SGR_PARAMS[i][0] for i in sgr_idxs], np.int32)
    s1s = np.asarray([SGR_PARAMS[i][1] for i in sgr_idxs], np.int32)
    w0w1 = np.stack([wts[:, 0], 128 - (wts[:, 0] + wts[:, 1])], axis=1).astype(np.int32)
    got = np.asarray(sgr_batch(cur, tmps, s0s, s1s, w0w1, w, h, kind, bpc))
    np.testing.assert_array_equal(got, np.stack(want))
