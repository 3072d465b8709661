"""Card-only checks, run on the GPU by chip_smoke.py (phase 7) or by
`python -m pytest -m gpu tests/` on a machine with a card; they skip on the
CPU backend.

- the engine's whole dense pass on the card equals the host path on a
  generated GOP;
- the inverse transforms compiled for the card equal the numpy reference.
"""

import jax
import numpy as np
import pytest

from rav1d_jax.gen.stream import StreamSpec, stream_path
from rav1d_jax.testing import decode_md5

pytestmark = pytest.mark.gpu


def test_engine_matches_host_on_card(gpu):
    """At chip_smoke.py's S1 geometry, so the programs it compiled serve."""
    from rav1d_jax import engine

    path = stream_path(StreamSpec(seed=11, width=1920, height=1080, frames=2))
    engine.stats.update(frames=0, fallback=0)
    got, n = decode_md5(path, engine=True)
    assert engine.stats == {"frames": 2, "fallback": 0}
    assert (got, n) == decode_md5(path, engine=False)


@pytest.mark.parametrize("bpc", [8, 10])
def test_itx_on_card_matches_reference(gpu, bpc):
    from rav1d_jax.engine.kernels import TXTP_FIRST, TXTP_SECOND, itx_any_core
    from rav1d_jax.ops.ref import itx as R
    from rav1d_jax.syntax.levels import ADST_DCT

    rng = np.random.default_rng(bpc)
    for w, h in [(4, 4), (8, 16)]:
        sh, sw = min(h, 32), min(w, 32)
        t = ADST_DCT
        n = 512
        cb = rng.integers(-(1 << (bpc + 3)), 1 << (bpc + 3),
                          (n, sh, sw)).astype(np.int32)
        f = np.full(n, TXTP_FIRST[t])
        s = np.full(n, TXTP_SECOND[t])
        x = jax.device_put(cb, gpu)
        got = np.asarray(jax.jit(itx_any_core, static_argnums=(3, 4, 5))(
            x, f, s, w, h, bpc))
        want = R.compute_residual_batch(
            cb.transpose(0, 2, 1).reshape(n, sw * sh),
            np.full(n, sw * sh - 1), w, h, t, bpc)
        np.testing.assert_array_equal(got, want)
