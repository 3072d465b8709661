"""Device-engine parity: full decodes through the engine (RAV1D_ENGINE=jax)
must reproduce the host numpy path bit-exactly, with no host fallback, on
generated streams (tests/conftest.py pins the CPU backend)."""

import pytest

from conftest import gen_stream
from rav1d_jax import engine
from rav1d_jax.testing import decode_md5

SPECS = [
    dict(seed=101, width=128, height=96, bpc=8, frames=3),   # key + 2 inter
    dict(seed=102, width=128, height=96, bpc=10, frames=2),  # key + inter
]


@pytest.mark.parametrize("spec", SPECS, ids=["8bit-gop", "10bit-gop"])
def test_engine_md5(spec):
    path = gen_stream(**spec)
    engine.stats.update(frames=0, fallback=0)
    got, n = decode_md5(path, engine=True)
    assert engine.stats == {"frames": spec["frames"], "fallback": 0}
    assert (got, n) == decode_md5(path, engine=False)
