"""Thread-count invariance of the tile-parallel syntax plane: decoding
with --threads N must be bit-exact vs serial for any N (the reference's
gate re-runs MD5-verified vectors with --threads 2, test.sh:63-67; tiles
have independent entropy state, src/internal.rs:824-845)."""

import pytest

from conftest import gen_stream
from rav1d_jax.decoder import Decoder, EAgain, Settings
from rav1d_jax.io.ivf import IvfDemuxer
from rav1d_jax.io.muxers import Md5Muxer

# generated multi-tile streams (uniform power-of-two grids)
VECTORS = [
    (dict(seed=15, width=512, height=256, frames=2), (4, 2)),
    (dict(seed=9, width=256, height=192, frames=3), (2, 2)),
    (dict(seed=29, width=128, height=256, frames=2), (1, 4)),   # rows only
]


def _md5(path, threads):
    dec = Decoder(Settings(apply_grain=False, n_threads=threads))
    mux = Md5Muxer()
    n = 0
    for pkt in IvfDemuxer(path):
        dec.send_data(pkt.data, pkt.timestamp)
        while True:
            try:
                mux.write_picture(dec.get_picture())
                n += 1
            except EAgain:
                break
    assert n > 0
    return mux.digest()


@pytest.mark.parametrize("spec,grid", VECTORS,
                         ids=["grid4x2", "grid2x2", "grid1x4"])
def test_threads_invariant(spec, grid):
    path = gen_stream(tiles=grid, **spec)
    serial = _md5(path, 1)
    for threads in (2, 4):
        assert _md5(path, threads) == serial, f"threads={threads}"
