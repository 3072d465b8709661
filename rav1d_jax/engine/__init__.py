"""Device-resident dense engine.

This is the accelerator execution path of the decoder: after the (host, C) syntax
pass has emitted the frame's work items + coefficient store, the engine
ships everything to the device once and runs the whole dense pass there —
batched inter prediction, batched inverse transforms, palette scatters, and
the intra wavefront as wave-batched device steps — then fetches pixels once.

This replaces the role of rav1d's fn-ptr DSP dispatch + per-thread recon
replay (src/internal.rs:112-121, src/recon.rs recon_b_intra/inter): instead
of per-block function calls, work is grouped into static-shape batches and
the *pixel dependencies* of intra prediction are honored by a host-computed
wave schedule (see plan.py).

Gate: RAV1D_ENGINE=jax selects the engine, RAV1D_ENGINE=np (and the
default, auto) the host numpy path. The engine becomes the default once
it decodes every supported stream without host fallback and is measured
faster on the card (ROADMAP design 3.4).
"""

from __future__ import annotations

import os


def enabled() -> bool:
    mode = os.environ.get("RAV1D_ENGINE", "auto")
    if mode == "np":
        return False
    if mode == "jax":
        return True
    return False  # auto: host path is the measured-faster default


# engine execution counters: frames run on the device path, and frames
# that fell back to the host path (reported by chip_smoke.py and bench.py)
stats = {"frames": 0, "fallback": 0}


def run_dense(t, f, tile_states, sbrow_marks, cols) -> bool:
    """Run the dense pass on device. Returns False when the frame uses a
    feature the engine does not cover yet (caller falls back to the numpy
    path)."""
    from .plan import build_plan
    from .run2 import execute

    stats["frames"] += 1
    plan = build_plan(t, f)
    ok = plan is not None and execute(f, plan)
    if not ok:
        stats["fallback"] += 1
        import os

        if os.environ.get("RAV1D_ENGINE_TRACE"):
            import traceback

            print("[engine] fallback: plan=%s" % (plan is not None),
                  flush=True)
    return ok
