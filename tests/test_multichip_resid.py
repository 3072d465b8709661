"""Stream-driven multi-device check: the inverse-transform batch of a
decoded frame, sharded over meshes of 1/2/4/8 devices, must reproduce the
single-device residual plane bit-exactly.

This exercises rav1d_jax.parallel.resid on coefficients captured from the
decoder on a generated stream (not synthetic tensors) — the
mesh-invariance oracle DESIGN.md promises (same output on any mesh
shape)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from rav1d_jax.parallel.resid import (
    capture_frame,
    group_residuals,
    sharded_residual_plane,
    single_device_residual_plane,
)

@pytest.fixture(scope="module")
def frame_data():
    import __graft_entry__
    from rav1d_jax.gen.stream import stream_path

    f = capture_frame(stream_path(__graft_entry__._multichip_spec()),
                      frame_idx=0)
    store = f.coef_store
    ah, aw = f.cur.y.shape
    psz = ah * aw
    cfbuf = jnp.asarray(store.cf[: store.cf_pos])
    return store, cfbuf, psz, aw, f.cur.bpc


def test_real_frame_has_work(frame_data):
    store, cfbuf, psz, aw, bpc = frame_data
    assert store.tx_pos > 100  # a real frame's worth of transform blocks


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_mesh_invariant_residual_plane(frame_data, ndev):
    store, cfbuf, psz, aw, bpc = frame_data
    groups = group_residuals(store, psz, aw, ndev)
    assert groups
    oracle = np.asarray(
        single_device_residual_plane(cfbuf, groups, psz, aw, bpc)
    )
    assert np.abs(oracle).sum() > 0  # non-trivial residuals
    devs = jax.devices()[:ndev]
    mesh = Mesh(np.array(devs), ("blk",))
    got = np.asarray(
        sharded_residual_plane(mesh, "blk", cfbuf, groups, psz, aw, bpc)
    )
    np.testing.assert_array_equal(got, oracle)
