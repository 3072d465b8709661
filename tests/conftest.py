import os
import sys

import pytest

# Tests run on the CPU backend with 8 virtual devices, so the sharded paths
# are exercised without a card. Card-only tests carry the `gpu` marker and
# run on the GPU through chip_smoke.py.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

# persistent compile cache: JAX_COMPILATION_CACHE_DIR when set (JAX reads it
# itself), else the checkout's own .jax_cache
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", os.path.join(ROOT, ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return devs[0]


def gen_stream(**spec) -> str:
    """Path of a generated test stream (rav1d_jax/gen; `spec` are
    StreamSpec fields), cached under .streams/."""
    from rav1d_jax.gen.stream import StreamSpec, stream_path

    return stream_path(StreamSpec(**spec))
