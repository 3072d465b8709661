#!/usr/bin/env python
"""Engine per-stage ablation: time the four device programs on a captured
frame blob, then re-time with descriptor groups zeroed (data-only, same
compile) to attribute execution cost per stage.

Usage:
  RAV1D_ENGINE=jax RAV1D_ENGINE_CAPTURE=/tmp/cap python -m <decode...>
  python tools_py/ablate.py /tmp/cap/frame005.npz

The zeroing touches only header COUNT words, so every variant reuses the
same compiled programs — differences are pure device execution time.
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from rav1d_jax.engine import mega  # noqa: E402
from rav1d_jax.engine.blob2 import bucket_pow2  # noqa: E402
from rav1d_jax.engine.mega import (  # noqa: E402
    INTER0, LR0, PAL0, R0, SIZES, SLOTS, WAVE0, WHT0,
    filter_prog, inter_prog, resid_prog, wave_prog,
)

GROUPS = {
    "resid": [R0 + 2 * i + 1 for i in range(len(SIZES))] + [WHT0 + 1],
    "pal": [PAL0 + 1],
    "wave": [WAVE0],
    "puts": [INTER0 + 2 * SLOTS[s] + 1 for s in ("putY", "putC", "lapY", "lapC")],
    "warps": [INTER0 + 2 * SLOTS[s] + 1 for s in ("warpY", "warpC")],
    "preps": [INTER0 + 2 * SLOTS[s] + 1
              for s in ("prepY", "prepC", "wprepY", "wprepC", "hostpool")],
    "combs": [INTER0 + 2 * SLOTS[s] + 1
              for s in ("avg", "segy00", "segy10", "segy11", "mask", "seguv")],
    "blend": [INTER0 + 2 * SLOTS["blend"] + 1],
    "lr": [LR0 + 2 * i + 1 for i in range(12)],
}


def run_all(buf, z, cap, meta, stacks, reps=5):
    import jax
    import jax.numpy as jnp

    hdr = buf[: mega.HDR_LEN].copy()
    b = buf.copy()
    for w in z:
        b[w] = 0
    dev = jnp.pad(jnp.asarray(b), (0, cap - b.size))
    jax.block_until_ready(dev)
    ah, aw, bpc = int(meta["ah"]), int(meta["aw"]), int(meta["bpc"])
    ss_hor, ss_ver = int(meta["ss_hor"]), int(meta["ss_ver"])
    layout = int(meta["layout"])
    w, h = int(meta["w"]), int(meta["h"])
    bw, bh = int(meta["bw"]), int(meta["bh"])
    lr_ws = tuple(int(x) for x in meta["lr_ws"])
    need_sr = bool(int(meta["need_sr"]))
    stackY, stackC = stacks
    vwC = (w + ss_hor) >> ss_hor
    vhC = (h + ss_ver) >> ss_ver
    ach = acw = 0
    # chroma aligned dims from stack shapes (I400 has no chroma)
    if layout != 0:
        ach, acw = (h + ss_ver) >> ss_ver, (w + ss_hor) >> ss_hor
        ach = (ach + 127) & ~127
        acw = (acw + 127) & ~127
    geom = (ah, aw, ach, acw, bh, bw, h)

    ts = {k: [] for k in ("resid", "inter", "wave", "filter", "fetch")}
    for _ in range(reps):
        t0 = time.perf_counter()
        ra, planes = resid_prog(dev, ah=ah, aw=aw, bpc=bpc)
        jax.block_until_ready(planes)
        t1 = time.perf_counter()
        if stackY is not None:
            planes = inter_prog(planes, ra, dev, stackY, stackC, ah=ah,
                                aw=aw, bpc=bpc, vwY=w, vhY=h, vwC=vwC,
                                vhC=vhC)
            jax.block_until_ready(planes)
        t2 = time.perf_counter()
        planes = wave_prog(planes, ra, dev, ah=ah, aw=aw, bpc=bpc,
                           ss_hor=ss_hor, ss_ver=ss_ver)
        jax.block_until_ready(planes)
        t3 = time.perf_counter()
        dev_out, packed = filter_prog(planes, dev, geom=geom, bpc=bpc,
                                      layout_i=layout, need_sr=need_sr,
                                      sr_geom=None, lr_ws=lr_ws)
        jax.block_until_ready(packed)
        t4 = time.perf_counter()
        np.asarray(packed)
        t5 = time.perf_counter()
        for k, d in zip(("resid", "inter", "wave", "filter", "fetch"),
                        (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            ts[k].append(d * 1e3)
    med = {k: round(sorted(v)[len(v) // 2], 1) for k, v in ts.items()}
    med["hdr_counts"] = {
        "waves": int(hdr[WAVE0]),
        "itx_chunks": sum(int(hdr[R0 + 2 * i + 1]) for i in range(len(SIZES))),
    }
    return med


def main():
    import jax.numpy as jnp

    path = sys.argv[1]
    d = np.load(path)
    buf = d["buf"]
    cap = bucket_pow2(int(sys.argv[2]) if len(sys.argv) > 2 else buf.size)
    meta = {k: d[k] for k in ("ah", "aw", "bpc", "layout", "ss_hor",
                              "ss_ver", "lr_ws", "need_sr", "w", "h",
                              "bw", "bh")}
    stackY = stackC = None
    if "nsrcY" in d.files:
        rows = [jnp.asarray(d[f"srcY{i}"]) for i in range(int(d["nsrcY"]))]
        while len(rows) < 8:
            rows.append(rows[0])
        stackY = jnp.stack(rows[:8])
        rows = [jnp.asarray(d[f"srcC{i}"]) for i in range(int(d["nsrcC"]))]
        if not rows:
            stackC = stackY[:1]
        else:
            while len(rows) < 16:
                rows.append(rows[0])
            stackC = jnp.stack(rows[:16])

    base = run_all(buf, [], cap, meta, (stackY, stackC))
    print("baseline:", base)
    for name, words in GROUPS.items():
        r = run_all(buf, words, cap, meta, (stackY, stackC))
        print(f"-{name}:", {k: r[k] for k in
                            ("resid", "inter", "wave", "filter", "fetch")})


if __name__ == "__main__":
    main()
