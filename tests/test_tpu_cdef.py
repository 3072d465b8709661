"""Bit-exactness of device CDEF vs the numpy reference."""

import numpy as np

from rav1d_jax.ops.ref import cdef as R


def test_find_dir_batch():
    from rav1d_jax.ops.dev.cdef import find_dir_batch

    rng = np.random.RandomState(5)
    for bpc in (8, 10):
        blocks = rng.randint(0, 1 << bpc, (64, 8, 8)).astype(np.int32)
        d, v = find_dir_batch(blocks, bpc)
        d, v = np.asarray(d), np.asarray(v)
        for n in range(blocks.shape[0]):
            rd, rv = R.find_dir(blocks[n], bpc)
            assert (d[n], v[n]) == (rd, rv), (bpc, n, (d[n], v[n]), (rd, rv))


def test_cdef_filter_batch():
    from rav1d_jax.ops.dev.cdef import cdef_filter_batch

    rng = np.random.RandomState(6)
    bpc = 8
    N = 48
    h = w = 8
    tiles = rng.randint(0, 256, (N, h + 4, w + 4)).astype(np.int32)
    # random MISSING borders to model frame edges
    for n in range(N):
        if n % 3 == 0:
            tiles[n, :2, :] = R.MISSING
        if n % 4 == 0:
            tiles[n, :, :2] = R.MISSING
        if n % 5 == 0:
            tiles[n, -2:, :] = R.MISSING
    pri = rng.randint(0, 16, N).astype(np.int32)
    sec = np.asarray([0, 1, 2, 4] * (N // 4), dtype=np.int32)
    pri[::7] = 0
    direction = rng.randint(0, 8, N).astype(np.int32)
    damping = np.full(N, 5, dtype=np.int32)

    got = np.asarray(cdef_filter_batch(tiles, pri, sec, direction, damping, bpc))

    for n in range(N):
        if pri[n] == 0 and sec[n] == 0:
            expect = tiles[n, 2:-2, 2:-2]
        else:
            # drive the reference: src = interior of the tile (it rebuilds
            # padding itself), so instead call the low-level path by
            # reconstructing dst from the tile
            dst = tiles[n, 2 : 2 + h, 2 : 2 + w].astype(np.int64).copy()
            _ref_filter_tile(dst, tiles[n], pri[n], sec[n], direction[n], 5, bpc)
            expect = dst
        assert np.array_equal(got[n], expect), n


def _ref_filter_tile(dst, tile, pri, sec, direction, damping, bpc):
    """Reference filter on a pre-padded tile (mirrors cdef_filter_block but
    reading the provided padding instead of building it)."""
    h, w = dst.shape
    tmp = tile.astype(np.int64)
    bdm8 = bpc - 8
    if pri:
        pri_tap = 4 - ((int(pri) >> bdm8) & 1)
        pri_shift = max(0, damping - (int(pri).bit_length() - 1))
    sec_shift = damping - (int(sec).bit_length() - 1) if sec else 0

    from rav1d_jax.tables.spec_data import CDEF_DIRECTIONS

    def off(o):
        o = int(o)
        dy = (o + 6) // 12
        return dy, o - dy * 12

    def constrain(diff, threshold, shift):
        adiff = abs(diff)
        v = min(adiff, max(0, threshold - (adiff >> shift)))
        return -v if diff < 0 else v

    for yy in range(h):
        for xx in range(w):
            px = int(dst[yy, xx])
            ty, tx = 2 + yy, 2 + xx
            s = 0
            if pri and sec:
                mx_ = mn_ = px
                tap = pri_tap
                for k in range(2):
                    oy, ox = off(CDEF_DIRECTIONS[direction + 2][k])
                    p0 = int(tmp[ty + oy, tx + ox]); p1 = int(tmp[ty - oy, tx - ox])
                    s += tap * (constrain(p0 - px, pri, pri_shift) + constrain(p1 - px, pri, pri_shift))
                    tap = (tap & 3) | 2
                    for v in (p0, p1):
                        mn_ = v if (v & 0xFFFFFFFF) < (mn_ & 0xFFFFFFFF) else mn_
                        mx_ = max(v, mx_)
                    oy2, ox2 = off(CDEF_DIRECTIONS[direction + 4][k])
                    oy3, ox3 = off(CDEF_DIRECTIONS[direction + 0][k])
                    vals = [int(tmp[ty + oy2, tx + ox2]), int(tmp[ty - oy2, tx - ox2]),
                            int(tmp[ty + oy3, tx + ox3]), int(tmp[ty - oy3, tx - ox3])]
                    st = 2 - k
                    for v in vals:
                        s += st * constrain(v - px, sec, sec_shift)
                        mn_ = v if (v & 0xFFFFFFFF) < (mn_ & 0xFFFFFFFF) else mn_
                        mx_ = max(v, mx_)
                out = px + ((s - (1 if s < 0 else 0) + 8) >> 4)
                dst[yy, xx] = max(mn_, min(out, mx_))
            elif pri:
                tap = pri_tap
                for k in range(2):
                    oy, ox = off(CDEF_DIRECTIONS[direction + 2][k])
                    p0 = int(tmp[ty + oy, tx + ox]); p1 = int(tmp[ty - oy, tx - ox])
                    s += tap * (constrain(p0 - px, pri, pri_shift) + constrain(p1 - px, pri, pri_shift))
                    tap = (tap & 3) | 2
                dst[yy, xx] = px + ((s - (1 if s < 0 else 0) + 8) >> 4)
            else:
                for k in range(2):
                    oy2, ox2 = off(CDEF_DIRECTIONS[direction + 4][k])
                    oy3, ox3 = off(CDEF_DIRECTIONS[direction + 0][k])
                    vals = [int(tmp[ty + oy2, tx + ox2]), int(tmp[ty - oy2, tx - ox2]),
                            int(tmp[ty + oy3, tx + ox3]), int(tmp[ty - oy3, tx - ox3])]
                    st = 2 - k
                    for v in vals:
                        s += st * constrain(v - px, sec, sec_shift)
                dst[yy, xx] = px + ((s - (1 if s < 0 else 0) + 8) >> 4)
