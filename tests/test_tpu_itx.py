"""Bit-exactness of the device (jax) batched itx vs the scalar reference."""

import numpy as np
import pytest

from rav1d_jax.ops.ref import itx as R
from rav1d_jax.syntax.levels import (
    DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
    FLIPADST_FLIPADST, IDTX, V_DCT, H_ADST,
)


CASES = [
    (4, 4, DCT_DCT), (8, 8, ADST_ADST), (16, 16, DCT_DCT), (32, 32, DCT_DCT),
    (4, 8, ADST_DCT), (8, 4, DCT_ADST), (16, 8, FLIPADST_DCT),
    (8, 16, DCT_FLIPADST), (16, 4, FLIPADST_FLIPADST), (4, 16, IDTX),
    (32, 16, V_DCT), (8, 32, H_ADST), (64, 64, DCT_DCT), (16, 64, DCT_DCT),
    (64, 32, DCT_DCT),
]


@pytest.mark.slow
@pytest.mark.parametrize("w,h,txtp", CASES)
@pytest.mark.parametrize("bpc", [8, 10])
def test_itx_batch_matches_ref(w, h, txtp, bpc):
    from rav1d_jax.ops.dev.itx import itx_add_batch

    rng = np.random.RandomState(hash((w, h, txtp, bpc)) & 0xFFFF)
    N = 5
    sh, sw = min(h, 32), min(w, 32)
    mag = 1 << (bpc + 3)
    coeff = rng.randint(-mag, mag, (N, sh, sw)).astype(np.int32)
    dstpx = rng.randint(0, (1 << bpc), (N, h, w)).astype(np.int32)

    got = np.asarray(itx_add_batch(dstpx, coeff, w, h, txtp, bpc))

    for n in range(N):
        # ref consumes rc layout: coeff_flat[x*sh + y] = cbuf[y, x]
        flat = np.zeros(sw * sh + 1, dtype=np.int64)
        flat[: sw * sh] = coeff[n].T.reshape(-1)
        dst = dstpx[n].astype(np.uint16).copy()
        R.inv_txfm_add(dst, flat, eob=sw * sh - 1, w=w, h=h, txtp=txtp, bpc=bpc)
        assert np.array_equal(got[n], dst.astype(np.int32)), (w, h, txtp, bpc, n)


def _run_case(w, h, txtp, bpc):
    from rav1d_jax.ops.dev.itx import itx_add_batch

    rng = np.random.RandomState(1)
    N = 3
    sh, sw = min(h, 32), min(w, 32)
    coeff = rng.randint(-2048, 2048, (N, sh, sw)).astype(np.int32)
    dstpx = rng.randint(0, 256, (N, h, w)).astype(np.int32)
    got = np.asarray(itx_add_batch(dstpx, coeff, w, h, txtp, bpc))
    for n in range(N):
        flat = np.zeros(sw * sh + 1, dtype=np.int64)
        flat[: sw * sh] = coeff[n].T.reshape(-1)
        dst = dstpx[n].astype(np.uint16).copy()
        R.inv_txfm_add(dst, flat, eob=sw * sh - 1, w=w, h=h, txtp=txtp, bpc=bpc)
        assert np.array_equal(got[n], dst.astype(np.int32))


def test_itx_batch_smoke():
    _run_case(8, 8, DCT_DCT, 8)
