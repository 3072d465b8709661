"""Per-frame engine timing probe: decodes N frames with RAV1D_ENGINE=jax,
printing wall time and persistent-cache growth per frame, flushing as
it goes — for diagnosing compile-key convergence (engine/blob.py)."""

import hashlib
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    vec = sys.argv[1]
    limit = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    os.environ.setdefault("RAV1D_ENGINE", "jax")
    from rav1d_jax.decoder import Decoder, EAgain, Settings
    from rav1d_jax.engine.run2 import cache_dir
    from rav1d_jax.io.ivf import IvfDemuxer

    cache = cache_dir()

    def cn():
        try:
            return len(os.listdir(cache))
        except OSError:
            return 0

    dec = Decoder(Settings(apply_grain=False))
    md5 = hashlib.md5()
    n = 0
    t0 = time.perf_counter()
    tprev = t0
    for pkt in IvfDemuxer(vec):
        dec.send_data(pkt.data, pkt.timestamp)
        while n < limit:
            try:
                pic = dec.get_picture()
            except EAgain:
                break
            for chunk in pic.iter_plane_rows():
                md5.update(chunk)
            n += 1
            now = time.perf_counter()
            print(f"frame {n}: {now - tprev:.2f}s cache={cn()}", flush=True)
            tprev = now
        if n >= limit:
            break
    dt = time.perf_counter() - t0
    print(f"DONE md5={md5.hexdigest()} frames={n} wall={dt:.1f}s "
          f"fps={n / dt:.2f}", flush=True)


if __name__ == "__main__":
    main()
