#!/usr/bin/env python
"""Smoke run of the decoder's device path on one GPU.

    python chip_smoke.py              # on a machine with one NVIDIA GPU
    python chip_smoke.py --rehearse   # tiny geometry on the CPU backend

Phases, in order; any failure exits non-zero:

1. device: JAX's devices and the card's name and power limit (nvidia-smi);
2. native core: the C entropy and syntax libraries, built from native/*.c;
3. streams: generated (or cached) AV1 streams, S1 = 1920x1080 8-bit 4:2:0,
   one key frame and 7 inter frames, and S2 = 1920x1080 10-bit, two key
   frames, every in-loop filter on;
4. compile: the four device programs for S1's geometry, with compile
   seconds and memory analysis, and the inverse transforms on the card
   against the numpy reference;
5. decode S1 through `Decoder` on the device programs and again on the
   host path, per-frame MD5s equal and no host fallback;
6. the same for S2;
7. the `gpu`-marked tests;
8. last line: {"ok": true, "device": {...}}.

The timings printed are a smoke check on the named card, not a benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def phase_device(rehearse):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"[device] {devs} kind={d.device_kind!r} count={len(devs)}")
    if rehearse:
        if d.platform != "cpu":
            sys.exit("--rehearse runs on the CPU backend (JAX_PLATFORMS=cpu)")
        return d, "cpu rehearsal"
    if d.platform != "gpu":
        sys.exit(f"no GPU: JAX's first device is {d.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if not card:
        sys.exit("nvidia-smi gave no card")
    log(card)
    return d, card


def phase_native():
    from rav1d_jax import native
    from rav1d_jax.native import syntax

    t0 = time.perf_counter()
    if not (native.AVAILABLE and native.LIB_REFMVS is not None
            and syntax.AVAILABLE):
        sys.exit("native entropy/refmvs/syntax libraries did not build")
    log(f"[native] C libraries ready in {time.perf_counter() - t0:.2f}s")


def phase_streams(specs):
    from rav1d_jax.gen.stream import stream_path
    from rav1d_jax.io.ivf import IvfDemuxer

    paths = {}
    for name, spec in specs.items():
        t0 = time.perf_counter()
        path = stream_path(spec)
        sizes = [len(p.data) for p in IvfDemuxer(path)]
        if len(sizes) != spec.frames:
            sys.exit(f"{name}: {len(sizes)} packets, want {spec.frames}")
        log(f"[streams] {name} {spec.name()}: {time.perf_counter() - t0:.1f}s "
            f"(generated or cached), {sum(sizes) // len(sizes)} bytes/frame")
        paths[name] = path
    return paths


def _geometry(spec):
    """The FrameContext fields run2.program_specs reads, for `spec`."""
    from types import SimpleNamespace

    from rav1d_jax.gen.stream import frame_headers
    from rav1d_jax.headers import PixelLayout
    from rav1d_jax.picture import alloc_picture

    fh = frame_headers(spec)[1][0]
    return SimpleNamespace(
        cur=alloc_picture(spec.width, spec.height, PixelLayout.I420, spec.bpc),
        bw=((spec.width + 7) >> 3) << 1,
        bh=((spec.height + 7) >> 3) << 1,
        frame_hdr=fh,
    )


def phase_compile(spec):
    from rav1d_jax.engine import run2

    for name, jitfn, statics, specs in run2.program_specs(_geometry(spec)):
        t0 = time.perf_counter()
        ex = run2.prog(name, jitfn, statics, specs)
        dt = time.perf_counter() - t0
        log(f"[compile] {name}: {dt:.1f}s; memory_analysis: "
            f"{ex.memory_analysis()}")


def itx_parity(n, bpc, sizes=((4, 4), (16, 8), (32, 32)), seed=0):
    """Inverse transforms of a few size classes and tx-type families, as
    compiled for the default device, against the numpy reference."""
    import jax
    import numpy as np

    from rav1d_jax.engine.kernels import TXTP_FIRST, TXTP_SECOND, itx_any_core
    from rav1d_jax.ops.ref import itx as R
    from rav1d_jax.syntax.levels import ADST_ADST, DCT_DCT, IDTX, V_DCT

    core = jax.jit(itx_any_core, static_argnums=(3, 4, 5))
    rng = np.random.default_rng(seed)
    for w, h in sizes:
        sh, sw = min(h, 32), min(w, 32)
        allowed = [DCT_DCT] if max(w, h) == 64 else (
            [DCT_DCT, IDTX] if max(w, h) == 32
            else [DCT_DCT, ADST_ADST, IDTX, V_DCT])
        txtp = rng.choice(allowed, n)
        mag = 1 << (bpc + 3)
        cb = rng.integers(-mag, mag, (n, sh, sw)).astype(np.int32)
        got = np.asarray(core(cb, TXTP_FIRST[txtp], TXTP_SECOND[txtp],
                              w, h, bpc))
        cfs = cb.transpose(0, 2, 1).reshape(n, sw * sh)
        eobs = np.full(n, sw * sh - 1)
        for t in allowed:
            sel = txtp == t
            want = R.compute_residual_batch(cfs[sel], eobs[sel], w, h, t, bpc)
            if not np.array_equal(got[sel], want):
                sys.exit(f"itx mismatch at {w}x{h} txtp {t} bpc {bpc}")
    return sizes


def decode_frames(path, engine):
    """Per-frame MD5s of a whole decode in the dav1d loop shape (one
    get_picture per send_data, then a drain), with wall and first-frame
    times."""
    from rav1d_jax import engine as eng
    from rav1d_jax.decoder import Decoder, EAgain, Settings
    from rav1d_jax.io.ivf import IvfDemuxer

    os.environ["RAV1D_ENGINE"] = "jax" if engine else "np"
    eng.stats.update(frames=0, fallback=0)
    md5s = []
    t0 = time.perf_counter()
    t_first = None

    def got(pic):
        nonlocal t_first
        h = hashlib.md5()
        for rows in pic.iter_plane_rows():
            h.update(rows)
        md5s.append(h.hexdigest())
        if t_first is None:
            t_first = time.perf_counter() - t0

    dec = Decoder(Settings(apply_grain=False))
    for pkt in IvfDemuxer(path):
        dec.send_data(pkt.data, pkt.timestamp)
        with contextlib.suppress(EAgain):
            got(dec.get_picture())
    while True:
        try:
            got(dec.get_picture())
        except EAgain:
            break
    dec.close()
    return md5s, time.perf_counter() - t0, t_first, dict(eng.stats)


def phase_decode(name, spec, path, card):
    from rav1d_jax.engine import run2

    for k in run2.stage_ms:
        run2.stage_ms[k] = 0.0
    dev_md5, wall, first, stats = decode_frames(path, engine=True)
    stage = {k: round(v, 1) for k, v in run2.stage_ms.items()}
    host_md5, host_wall, _, _ = decode_frames(path, engine=False)
    log(f"[decode {name}] smoke timing on {card}: {len(dev_md5)} frames, "
        f"device path {wall:.2f}s (first frame {first:.2f}s), host path "
        f"{host_wall:.2f}s, stage_ms {stage}, engine stats {stats}")
    if len(dev_md5) != spec.frames or len(host_md5) != spec.frames:
        sys.exit(f"{name}: {len(dev_md5)}/{len(host_md5)} frames, "
                 f"want {spec.frames}")
    if stats["fallback"] != 0 or stats["frames"] != spec.frames:
        sys.exit(f"{name}: engine stats {stats}")
    bad = [i for i, (a, b) in enumerate(zip(dev_md5, host_md5)) if a != b]
    if bad:
        sys.exit(f"{name}: device output differs from host on frames {bad}")
    log(f"[decode {name}] per-frame MD5s equal to the host path")


def phase_gpu_tests():
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    c = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")], plugins=[c])
    if rc != 0 or c.passed == 0:
        sys.exit(f"gpu tests: exit {rc}, {c.passed} passed")
    log(f"[gpu tests] {c.passed} passed")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="phases 2-5 at 128x96, 3 frames, on the CPU backend")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    dev, card = phase_device(args.rehearse)
    phase_native()

    from rav1d_jax.gen.stream import StreamSpec

    if args.rehearse:
        specs = {"S1": StreamSpec(seed=1, width=128, height=96, frames=3)}
    else:
        specs = {
            "S1": StreamSpec(seed=1, width=1920, height=1080, bpc=8, frames=8),
            "S2": StreamSpec(seed=2, width=1920, height=1080, bpc=10,
                             frames=2, kf_every=1),
        }
    paths = phase_streams(specs)

    t0 = time.perf_counter()
    phase_compile(specs["S1"])
    classes = itx_parity(n=64 if args.rehearse else 4096, bpc=8)
    log(f"[compile] itx on the device equals the numpy reference for "
        f"{classes} ({time.perf_counter() - t0:.1f}s for the compile phase)")

    for name, spec in specs.items():
        phase_decode(name, spec, paths[name], card)

    if args.rehearse:
        log("rehearsal passed (CPU backend: no device result)")
        return
    phase_gpu_tests()
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(__import__("jax").devices())}}))


if __name__ == "__main__":
    main()
