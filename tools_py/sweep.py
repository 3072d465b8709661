#!/usr/bin/env python
"""Conformance sweep: decode every dav1d test-data vector, compare MD5.

Parses the meson.build test lists under the reference test-data tree
(ref: tests/dav1d-test-data/*/meson.build) and decodes each vector with
rav1d_jax, verifying the plane MD5 exactly like `dav1d --verify <md5>`.

Usage:
  python tools_py/sweep.py [--suite 8-bit] [--jobs 2] [--timeout 120]
                           [--filter SUBSTR] [--out sweep_results.jsonl]
  python tools_py/sweep.py --worker <batch.json>   # internal

Results land in sweep_results.jsonl (one JSON object per vector) and a
summary is printed by subdir.
"""

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time
from collections import defaultdict

TEST_DATA = "/root/reference/tests/dav1d-test-data"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENTRY_RE = re.compile(r"\[\s*'([^']+)'\s*,\s*files\('([^']+)'\)\s*,\s*'([0-9a-f]{32})'")
# film-grain style standalone test() calls with --filmgrain 1
FG_RE = re.compile(
    r"test\('([^']+)'[^)]*?files\('([^']+)'\),\s*'--filmgrain',\s*'1',\s*"
    r"'--verify',\s*'([0-9a-f]{32})'",
    re.S,
)


def collect(suites):
    """Yield (name, path, md5, filmgrain) from all meson lists."""
    seen = set()
    for suite in suites:
        base = os.path.join(TEST_DATA, suite)
        for dirpath, _dirs, files in os.walk(base):
            if "meson.build" not in files:
                continue
            text = open(os.path.join(dirpath, "meson.build")).read()
            for name, fname, md5 in ENTRY_RE.findall(text):
                path = os.path.join(dirpath, fname)
                key = (path, md5, False)
                if key not in seen and os.path.exists(path):
                    seen.add(key)
                    yield name, path, md5, False
            for name, fname, md5 in FG_RE.findall(text):
                path = os.path.join(dirpath, fname)
                key = (path, md5, True)
                if key not in seen and os.path.exists(path):
                    seen.add(key)
                    yield name, path, md5, True


def decode_one(path, expected, filmgrain, timeout_s):
    from rav1d_jax import engine as _engine
    from rav1d_jax.decoder import Decoder, EAgain, Settings
    from rav1d_jax.io import probe_demuxer
    from rav1d_jax.io.muxers import Md5Muxer

    _engine.stats.update(frames=0, fallback=0)

    def on_alarm(sig, frm):
        raise TimeoutError()

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(timeout_s)
    t0 = time.time()
    try:
        demux = probe_demuxer(path)
        dec = Decoder(Settings(apply_grain=filmgrain))
        md5 = Md5Muxer()
        n = 0
        for pkt in demux:
            dec.send_data(pkt.data, pkt.timestamp)
            # one get per send (dav1d.c main-loop shape): keeps the
            # engine's delayed-output ring full so d2h fetches batch
            try:
                md5.write_picture(dec.get_picture())
                n += 1
            except EAgain:
                pass
        while True:  # drain
            try:
                md5.write_picture(dec.get_picture())
                n += 1
            except EAgain:
                break
        got = md5.digest()
        status = "pass" if got == expected else "mismatch"
        res = {"status": status, "md5": got, "frames": n, "secs": round(time.time() - t0, 2)}
        if os.environ.get("RAV1D_ENGINE") == "jax":
            res["engine_frames"] = _engine.stats["frames"]
            res["engine_fallback"] = _engine.stats["fallback"]
        return res
    except TimeoutError:
        return {"status": "timeout", "secs": round(time.time() - t0, 2)}
    except Exception as e:  # noqa: BLE001
        return {
            "status": "error",
            "error": f"{type(e).__name__}: {e}"[:300],
            "secs": round(time.time() - t0, 2),
        }
    finally:
        signal.alarm(0)


def worker_main(batch_file):
    sys.path.insert(0, ROOT)
    batch = json.load(open(batch_file))
    if batch.get("engine"):
        # engine sweep: force the device path on the CPU backend, so the
        # sweep runs on a machine without a card (engine/run2.py keeps the
        # persistent compile cache)
        os.environ["RAV1D_ENGINE"] = "jax"
        os.environ["JAX_PLATFORMS"] = "cpu"
    out = open(batch["out"], "a", buffering=1)
    for name, path, md5, fg in batch["items"]:
        res = decode_one(path, md5, fg, batch["timeout"])
        res.update(name=name, path=os.path.relpath(path, TEST_DATA), fg=fg)
        out.write(json.dumps(res) + "\n")
    out.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", action="append", default=None)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=120)
    ap.add_argument("--filter", default=None)
    ap.add_argument("--out", default="sweep_results.jsonl")
    ap.add_argument("--worker", default=None)
    ap.add_argument("--engine", action="store_true",
                    help="force the device engine (RAV1D_ENGINE=jax) on "
                         "the local CPU backend; records fallback counts")
    ap.add_argument("--stratify", type=int, default=0,
                    help="take only the first N vectors of each subdir")
    ap.add_argument("--chunk", type=int, default=6,
                    help="vectors per worker subprocess (memory bound)")
    args = ap.parse_args()

    if args.worker:
        worker_main(args.worker)
        return

    suites = args.suite or ["8-bit", "10-bit", "12-bit", "multi-bit"]
    items = list(collect(suites))
    if args.filter:
        items = [it for it in items if args.filter in it[1]]
    if args.stratify:
        bycount = defaultdict(int)
        kept = []
        for it in items:
            d = os.path.dirname(it[1])
            if bycount[d] < args.stratify:
                bycount[d] += 1
                kept.append(it)
        items = kept
    print(f"{len(items)} vectors")
    # strip stale results for items we're about to re-run
    done = {}
    if os.path.exists(args.out):
        for line in open(args.out):
            try:
                r = json.loads(line)
                done[(r["path"], r["fg"])] = r
            except (json.JSONDecodeError, KeyError):
                pass
    todo = [it for it in items if (os.path.relpath(it[1], TEST_DATA), it[3]) not in done]
    print(f"{len(todo)} to run ({len(items) - len(todo)} cached in {args.out})")

    # round-robin batches so slow dirs spread across workers; each worker
    # subprocess handles at most `chunk` vectors then exits — engine-mode
    # CPU workers accumulate one compiled program set per geometry and a
    # single long-lived worker OOMs ("LLVM compilation error: Cannot
    # allocate memory" after ~45 vectors on this 2-core box)
    batches = [todo[i :: args.jobs] for i in range(args.jobs)]
    chunk = max(1, args.chunk)
    for start in range(0, max(len(b) for b in batches if b), chunk):
        procs = []
        for i, b in enumerate(batches):
            piece = b[start : start + chunk]
            if not piece:
                continue
            bf = f"/tmp/sweep_batch_{i}_{start}.json"
            json.dump({"items": piece, "out": args.out,
                       "timeout": args.timeout, "engine": args.engine},
                      open(bf, "w"))
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--worker", bf], env=env))
        for p in procs:
            p.wait()

    # summary
    results = []
    for line in open(args.out):
        try:
            results.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    bydir = defaultdict(lambda: defaultdict(int))
    for r in results:
        d = os.path.dirname(r["path"])
        bydir[d][r["status"]] += 1
    total = defaultdict(int)
    for d in sorted(bydir):
        s = bydir[d]
        for k, v in s.items():
            total[k] += v
        print(f"{d:40s} " + " ".join(f"{k}={v}" for k, v in sorted(s.items())))
    print("TOTAL", dict(total))


if __name__ == "__main__":
    main()
