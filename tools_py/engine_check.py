"""Engine-vs-numpy parity checker: decode vectors twice (numpy replay path
and the device engine) and compare output MD5s. The reference here is the
in-repo numpy path — which itself is held to the meson MD5 oracle by
tools_py/sweep.py — so this tool isolates engine-only regressions; a bug
shared with the syntax pass would not be caught here (run sweep.py for
that). Runs on the CPU backend unless --gpu is given, so the parity
check works on a machine without a card.

Usage: python tools_py/engine_check.py VEC [VEC...] [--limit N] [--gpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TEST_DATA = "/root/reference/tests/dav1d-test-data"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("vectors", nargs="+")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--gpu", action="store_true")
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cuda" if args.gpu else "cpu"

    from rav1d_jax.testing import decode_md5

    fails = 0
    for vec in args.vectors:
        path = vec if os.path.exists(vec) else os.path.join(TEST_DATA, vec)
        try:
            ref, n = decode_md5(path, engine=False, limit=args.limit)
        except Exception as e:  # noqa: BLE001
            print(f"SKIP {vec}: numpy path failed: {e}")
            continue
        try:
            got, _ = decode_md5(path, engine=True, limit=args.limit)
        except Exception as e:  # noqa: BLE001
            import traceback

            traceback.print_exc()
            print(f"FAIL {vec}: engine raised: {e}")
            fails += 1
            continue
        ok = got == ref
        fails += 0 if ok else 1
        print(f"{'ok  ' if ok else 'FAIL'} {vec} ({n} frames) {ref} {got}")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
