"""Engine v3 executor: pack the frame into ONE blob, run FOUR programs.

Host side of engine/mega.py: walks the frame plan and serializes every
descriptor into the flat staging buffer (engine/blob2.py), records region
offsets/counts in the header words, uploads once, then dispatches
resid_prog -> inter_prog -> wave_prog -> filter_prog and attaches the
packed output to the picture as an async fetch.

Per-frame device traffic: 1 upload + 4 dispatches + 1 async download —
replacing round-3's hundreds of eager dispatches (the measured ~0.1-1.4 ms
per dependent dispatch made that a seconds-per-frame floor).

Role parity: rav1d_decode_frame's recon + filter drive
(src/decode.rs:4497, src/recon.rs:4047-4338), collapsed per frame.
"""

from __future__ import annotations

import os

import numpy as np

from ..syntax.levels import WHT_WHT
from .blob2 import FrameBlob
from .kernels import TXTP_FIRST, TXTP_SECOND, chunk_for
from .mega import (
    CDEF0, CF0, DB0, HB, HDR_LEN, IH0, INTER0, LR0, LRB, NBLEND, NCOMB,
    NPUT, NWARP, PAL0, PAL_B, R0, SIZES, SLOTS, SR0, TB, WAVE0, WHT0, WHT_B,
    filter_prog, inter_prog, resid_prog, wave_prog,
)
from .plan import CAP, CLS_L, CLS_S, MODE_CFL_DC, MODE_IDENT, item_class

SIZE_IDX = {wh: i for i, wh in enumerate(SIZES)}


# ---------------------------------------------------------------------------
# Program cache + background warm.
#
# Tracing, lowering and compiling the four programs takes seconds to
# minutes per geometry and bit depth (the persistent XLA cache, setup_cache,
# skips only the compile). The cache below keys compiled executables by
# (program, static args, input shapes); warm_frame submits every program
# the stream will need to a small thread pool as soon as frame geometry is
# known, so the work overlaps the host syntax pass (the C walk releases the
# GIL) instead of stalling the first engine frame.
# ---------------------------------------------------------------------------

import threading as _threading
from concurrent.futures import ThreadPoolExecutor as _TPE

_PROGS = {}
_PROGS_LOCK = _threading.Lock()
_POOL = None


def _pool():
    global _POOL
    if _POOL is None:
        _POOL = _TPE(max_workers=3, thread_name_prefix="rav1d-warm")
    return _POOL


def _compile_prog(name, jitfn, statics, specs):
    import time as _time

    t0 = _time.perf_counter()
    lowered = jitfn.lower(*specs, **statics)
    t1 = _time.perf_counter()
    ex = lowered.compile()
    t2 = _time.perf_counter()
    if os.environ.get("RAV1D_COMPILE_TRACE") == "1":
        print(
            "[compile] %s lower %.1fs compile %.1fs"
            % (name, t1 - t0, t2 - t1),
            flush=True,
        )
    return ex


def _submit_prog(name, jitfn, statics, specs):
    key = (
        name,
        tuple(sorted(statics.items())),
        tuple((s.shape, str(s.dtype)) for s in specs),
    )
    with _PROGS_LOCK:
        fut = _PROGS.get(key)
        if fut is None:
            fut = _pool().submit(_compile_prog, name, jitfn, statics, specs)
            _PROGS[key] = fut
    return fut


def prog(name, jitfn, statics, args):
    """Compiled executable for (program, statics, arg shapes); blocks only
    if the warm thread has not finished this key yet. `args` may be arrays
    or shape specs."""
    import jax

    specs = tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in args)
    return _submit_prog(name, jitfn, statics, specs).result()


def det_cap_words(psz, bpc):
    """Deterministic device blob capacity for a frame geometry: a stable
    compile key the warm thread can predict before the first pack. Frames
    that overflow it fall back to the power-of-2 high-water path."""
    from .blob2 import bucket_pow2

    return bucket_pow2(psz * (8 if bpc == 8 else 16))


def warm_frame(f):
    """Pre-submit compiles for every program this stream's geometry needs
    (called from the decoder as soon as frame geometry is known)."""
    for name, jitfn, statics, specs in program_specs(f):
        _submit_prog(name, jitfn, statics, specs)


def program_specs(f):
    """(name, program, static args, argument specs) of every program a
    frame of `f`'s geometry runs. `f` needs the FrameContext fields cur,
    bh, bw and frame_hdr.restoration."""
    import jax
    import numpy as np_

    from ..headers import PixelLayout

    ah, aw = f.cur.y.shape
    psz = ah * aw
    bpc = f.cur.bpc
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    cap = det_cap_words(psz, bpc)
    i32 = np_.dtype(np_.int32)
    pdt = np_.dtype(np_.uint8 if bpc == 8 else np_.uint16)
    S = jax.ShapeDtypeStruct
    dev = S((cap,), i32)
    ra = S((6 * psz,), i32)
    planes = S((3, ah, aw), i32)
    out = [
        ("resid", resid_prog, dict(ah=ah, aw=aw, bpc=bpc), (dev,)),
        ("wave", wave_prog,
         dict(ah=ah, aw=aw, bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver),
         (planes, ra, dev)),
    ]
    if f.cur.u is not None:
        ach, acw = f.cur.u.shape
    else:
        ach = acw = 0
    vwC = (f.cur.w + ss_hor) >> ss_hor
    vhC = (f.cur.h + ss_ver) >> ss_ver
    stackY = S((8, ah, aw), pdt)
    stackC = S((16, ach, acw), pdt) if ach else S((1, ah, aw), pdt)
    out.append((
        "inter", inter_prog,
        dict(ah=ah, aw=aw, bpc=bpc, vwY=f.cur.w, vhY=f.cur.h,
             vwC=vwC, vhC=vhC),
        (planes, ra, dev, stackY, stackC),
    ))
    geom = (ah, aw, ach, acw, f.bh, f.bw, f.cur.h)
    lr_variants = {(96, 96)}
    us = getattr(f.frame_hdr.restoration, "unit_size", None)
    if us and us[0]:
        wy = (1 << us[0]) + ((1 << us[0]) >> 1)
        wc = (1 << us[1]) + ((1 << us[1]) >> 1) if us[1] else 96
        lr_variants.add((wy, wc))
    for lw in sorted(lr_variants):
        out.append((
            "filter", filter_prog,
            dict(geom=geom, bpc=bpc, layout_i=int(layout), need_sr=False,
                 sr_geom=None, lr_ws=lw),
            (planes, dev),
        ))
    return out


def cache_dir():
    """Where compiled programs persist across processes:
    JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..", ".jax_cache"
    )


def setup_cache():
    """Turn on JAX's persistent compilation cache. JAX reads
    JAX_COMPILATION_CACHE_DIR itself, so a directory is set here only when
    that variable is absent."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


setup_cache()


def _chunked(cols_rows, n, B, pads=None):
    """Stack per-item descriptor columns (rows, n) into (nc, rows, B) with
    per-row pad values (default 0)."""
    rows = len(cols_rows)
    nc = max((n + B - 1) // B, 0)
    d = np.zeros((nc, rows, B), np.int32)
    for r in range(rows):
        buf = np.full(nc * B, 0 if pads is None else pads[r], np.int32)
        buf[:n] = cols_rows[r]
        d[:, r, :] = buf.reshape(nc, B)
    return d, nc


# ------------------------------ residuals --------------------------------


def _pack_residuals(blob, hdr, store, plan, psz, aw):
    sels = []
    if plan.wavefront_tx is not None and plan.wavefront_tx.size:
        sels.append((np.asarray(plan.wavefront_tx), 0))
    if plan.inter is not None and plan.batch_tx is not None \
            and plan.batch_tx.size:
        sels.append((np.asarray(plan.batch_tx), 3 * psz))
    if not sels:
        return
    keys, offs, flat0s, f0s, f1s = [], [], [], [], []
    for sel, boff in sels:
        sel = sel[store.eob[sel] >= 0]
        if not sel.size:
            continue
        tps = store.txtp[sel].astype(np.int64)
        ws = store.txw[sel].astype(np.int64)
        hs = store.txh[sel].astype(np.int64)
        keys.append(np.where(tps == WHT_WHT, -1, ws * 2048 + hs))
        offs.append(store.cf_off[sel].astype(np.int32))
        flat0s.append(
            (store.txpl[sel].astype(np.int64) * psz
             + store.txy[sel].astype(np.int64) * aw
             + store.txx[sel] + boff).astype(np.int32)
        )
        f0s.append(TXTP_FIRST[tps])
        f1s.append(TXTP_SECOND[tps])
    if not keys:
        return
    key = np.concatenate(keys)
    offs = np.concatenate(offs)
    flat0 = np.concatenate(flat0s)
    f0 = np.concatenate(f0s)
    f1 = np.concatenate(f1s)
    oob = np.int32(6 * psz)
    for k in np.unique(key):
        m = key == k
        o, fl, a, b = offs[m], flat0[m], f0[m], f1[m]
        n = o.size
        if k == -1:
            d, nc = _chunked([o, fl], n, WHT_B, pads=[0, oob])
            hdr[WHT0] = blob.add_words(d)
            hdr[WHT0 + 1] = nc
        else:
            w, h = int(k) // 2048, int(k) % 2048
            B = chunk_for(w, h)
            d, nc = _chunked([o, fl, a, b], n, B, pads=[0, oob, 0, 0])
            si = SIZE_IDX[(w, h)]
            hdr[R0 + 2 * si] = blob.add_words(d)
            hdr[R0 + 2 * si + 1] = nc


# ------------------------------ palette ----------------------------------


def _pack_palette(blob, hdr, plan, psz, aw):
    if not plan.pal:
        return
    idxs, vals = [], []
    for pl, y, x, pix in plan.pal:
        h, w = pix.shape
        base = pl * psz + y * aw + x
        ii = base + np.arange(h)[:, None] * aw + np.arange(w)[None, :]
        idxs.append(ii.ravel().astype(np.int32))
        vals.append(pix.ravel().astype(np.int32))
    idx = np.concatenate(idxs)
    val = np.concatenate(vals)
    d, nc = _chunked([idx, val], idx.size, PAL_B, pads=[3 * psz, 0])
    hdr[PAL0] = blob.add_words(d)
    hdr[PAL0 + 1] = nc


# ------------------------------ wavefront --------------------------------


def _pack_class(items, NW, B, psz):
    """Pack one class's wave items into (NW, B, N_FIELDS) int32 rows
    (layout in wave2.FIELDS; the edge plan is the 5-field parametric
    descriptor expanded on device by wave2._build_coords). Lane 0 carries
    the per-wave feature flags and item count that let the device
    cond-skip absent features."""
    from ..syntax.levels import FILTER_PRED, Z1_PRED, Z2_PRED, Z3_PRED
    from .wave2 import (
        F_CFL, F_FILTER, F_IDENT, F_II, F_Z, FIELDS, N_FIELDS,
    )

    blob = np.zeros((NW, B, N_FIELDS), np.int32)
    fi = {k: i for i, k in enumerate(FIELDS)}
    blob[:, :, fi["flat0"]] = 3 * psz  # padded lanes scatter out of bounds
    blob[:, :, fi["w"]] = 4
    blob[:, :, fi["h"]] = 4
    blob[:, :, fi["iioff"]] = -1
    fill = np.zeros(NW, np.int32)
    wflags = np.zeros(NW, np.int32)
    for it, aw in items:
        wv = it.wave - 1
        k = fill[wv]
        fill[wv] += 1
        row = blob[wv, k]
        row[fi["modes"]] = it.mode
        row[fi["angles"]] = it.angle
        row[fi["flat0"]] = it.pl * psz + it.y * aw + it.x
        row[fi["rmask"]] = it.tx >= 0
        row[fi["z2mw"]] = it.z2_mw
        row[fi["z2mh"]] = it.z2_mh
        row[fi["z2sm"]] = it.z2_sm
        row[fi["w"]] = it.w
        row[fi["h"]] = it.h
        row[fi["iioff"]] = it.iioff
        row[fi["hav"]] = it.hav
        row[fi["phl"]] = it.phl
        row[fi["phbl"]] = it.phbl
        row[fi["pht"]] = it.pht
        row[fi["phtr"]] = it.phtr
        if it.mode in (Z1_PRED, Z2_PRED, Z3_PRED):
            wflags[wv] |= F_Z
        elif it.mode == FILTER_PRED:
            wflags[wv] |= F_FILTER
        elif it.mode == MODE_IDENT:
            wflags[wv] |= F_IDENT
        if it.iioff >= 0:
            wflags[wv] |= F_II
        if it.mode >= MODE_CFL_DC:
            wflags[wv] |= F_CFL
            row[fi["cfla"]] = it.cfl_alpha
            row[fi["cfl0"]] = it.cfl_ly * aw + it.cfl_lx
            row[fi["cflwp"]] = it.cfl_wpad
            row[fi["cflhp"]] = it.cfl_hpad
    blob[:, 0, fi["wflags"]] = wflags
    blob[:, 0, fi["wcount"]] = fill
    return blob


def _pack_wave(blob, hdr, plan, psz, aw):
    if plan.ii_masks:
        hdr[WAVE0 + 3] = blob.add_words(
            np.concatenate(plan.ii_masks).astype(np.int32)
        )
    if not plan.items:
        return
    sitems = [(it, aw) for it in plan.items if item_class(it.w, it.h) == 0]
    litems = [(it, aw) for it in plan.items if item_class(it.w, it.h) == 1]
    NW = max(plan.n_waves, 1)
    hdr[WAVE0] = NW
    hdr[WAVE0 + 1] = blob.add_words(_pack_class(sitems, NW, CAP[0], psz))
    hdr[WAVE0 + 2] = blob.add_words(_pack_class(litems, NW, CAP[1], psz))


# -------------------------------- inter ----------------------------------


def _pack_slot(blob, hdr, name, cols, rows, B=TB, case_row=None):
    """Pack a slot's tile descriptors into (nc, rows, B) chunks. With
    case_row set, chunks are CASE-PURE (grouped by that column): the
    device body lax.switches once per chunk and computes only that
    filter case's gather + taps."""
    if not cols:
        return
    a = np.asarray(cols, np.int32)
    if case_row is None:
        groups = [a]
    else:
        groups = [a[a[:, case_row] == c]
                  for c in np.unique(a[:, case_row])]
    chunks = []
    total = 0
    for g in groups:
        d, nc = _chunked(list(g.T), g.shape[0], B)
        if case_row is not None:
            d[:, case_row, :] = g[0, case_row]
        chunks.append(d)
        total += nc
    hdr[INTER0 + 2 * SLOTS[name]] = blob.add_words(np.concatenate(chunks))
    hdr[INTER0 + 2 * SLOTS[name] + 1] = total


def _plan_inter_v3(f, plan, blob, hdr, psz, aw):
    """Serialize the collected inter job lists into slot descriptor chunks
    (see engine/inter.py collect_inter for the job collection walk and
    engine/mega.py for the slot set). Returns (srcsY, srcsC) or None when
    a pool capacity would overflow (caller falls back to the host path)."""
    from ..recon.inter import _PrepHandle, _WarpPrepHandle
    from ..tables.spec_data import OBMC_MASKS
    from .inter import dev_plane  # noqa: F401  (stack build at exec)

    jobs = plan.inter
    POOLROWS = (8 * psz) // 64

    srcsY, srcsC = [], []
    srcrow = {}
    _src_pics = {}
    for refp in f.refp:
        if refp is None:
            continue
        for pl, arr in enumerate((refp.y, refp.u, refp.v)):
            if arr is not None and id(arr) not in _src_pics:
                _src_pics[id(arr)] = (refp, pl)

    def src_of(plane):
        key = id(plane)
        if key not in srcrow:
            pic, pl = _src_pics[key]
            if pl == 0:
                srcrow[key] = (0, len(srcsY))
                srcsY.append((pic, pl))
            else:
                srcrow[key] = (1, len(srcsC))
                srcsC.append((pic, pl))
        return srcrow[key]

    dstmap = {id(f.cur.y): 0}
    if f.cur.u is not None:
        dstmap[id(f.cur.u)] = 1
        dstmap[id(f.cur.v)] = 2

    # --- OBMC lap pool rows ---
    lap_rows = {}
    nlap = 0
    for kind, dst, dy, dx, lap, w, h in jobs.blends:
        if id(lap) not in lap_rows:
            lh, lw = lap.shape
            ntx = (lw + 7) >> 3
            nty = (lh + 7) >> 3
            lap_rows[id(lap)] = (nlap, ntx, nty, lw, lh)
            nlap += ntx * nty
    if nlap > POOLROWS:
        return None

    # --- puts (8-tap + bilin share slots; phases/bilin are data) ---
    put_cols = {("putY"): [], ("putC"): [], ("lapY"): [], ("lapC"): []}

    def add_put(job, bilin):
        dst, dsty, dstx, plane, dy, dx, w, h, fmx, fmy, f2d, vw, vh = job
        kind, row = src_of(plane)
        di = dstmap.get(id(dst))
        if di is None:
            g = put_cols["lapY" if kind == 0 else "lapC"]
        else:
            g = put_cols["putY" if kind == 0 else "putC"]
        # filter case (mega._put_out): 0 hv / 1 h / 2 v / 3 copy / 4 bilin
        if bilin:
            case = 4
        elif fmy:
            case = 0 if fmx else 2
        else:
            case = 1 if fmx else 3
        for ty in range(0, h, 8):
            th = min(8, h - ty)
            for tx in range(0, w, 8):
                tw = min(8, w - tx)
                if di is not None:
                    flat0 = di * psz + (dsty + ty) * aw + (dstx + tx)
                else:
                    base, ntx, nty, lw, lh = lap_rows[id(dst)]
                    if dsty + ty >= lh or dstx + tx >= lw:
                        continue
                    flat0 = (base + ((dsty + ty) >> 3) * ntx
                             + ((dstx + tx) >> 3)) * 64
                g.append((row, dy + ty, dx + tx, fmx, fmy, f2d, flat0,
                          tw, th, w, h, case))

    for job in jobs.mc:
        add_put(job, False)
    for job in jobs.bilin:
        add_put(job, True)
    for name, cols in put_cols.items():
        _pack_slot(blob, hdr, name, cols, NPUT, case_row=11)

    # --- warp puts ---
    warp_cols = {0: [], 1: []}
    for dst, dsty, dstx, plane, dy, dx, abcd, mx, my, vw, vh in jobs.warp:
        kind, row = src_of(plane)
        di = dstmap[id(dst)]
        flat0 = di * psz + dsty * aw + dstx
        warp_cols[kind].append(
            (row, dy, dx, abcd[0], abcd[1], abcd[2], abcd[3], mx, my,
             flat0, 8, 8)
        )
    _pack_slot(blob, hdr, "warpY", warp_cols[0], NWARP)
    _pack_slot(blob, hdr, "warpC", warp_cols[1], NWARP)

    # --- compound prep pool ---
    pool_rows = {}
    npool = 0
    prep_cols = {0: [], 1: []}
    for idx, (plane, dy, dx, w, h, fmx, fmy, f2d, vw, vh) in enumerate(
            jobs.prep):
        kind, row = src_of(plane)
        ntx = (w + 7) >> 3
        nty = (h + 7) >> 3
        pool_rows[("p", idx)] = (npool, ntx)
        g = prep_cols[kind]
        if fmy:
            case = 0 if fmx else 2
        else:
            case = 1 if fmx else 3
        for ty in range(0, h, 8):
            th = min(8, h - ty)
            for tx in range(0, w, 8):
                tw = min(8, w - tx)
                flat0 = (npool + (ty >> 3) * ntx + (tx >> 3)) * 64
                g.append((row, dy + ty, dx + tx, fmx, fmy, f2d, flat0,
                          tw, th, w, h, case))
        npool += ntx * nty
    _pack_slot(blob, hdr, "prepY", prep_cols[0], NPUT, case_row=11)
    _pack_slot(blob, hdr, "prepC", prep_cols[1], NPUT, case_row=11)

    wh_base = {}
    for hnd in jobs.warp_handles:
        ntx = (hnd.w + 7) >> 3
        nty = (hnd.h + 7) >> 3
        wh_base[hnd.idx] = (npool, ntx)
        pool_rows[("w", hnd.idx)] = (npool, ntx)
        npool += ntx * nty
    wprep_cols = {0: [], 1: []}
    for hidx, y, x, plane, dy, dx, abcd, mx, my, vw, vh in jobs.warp_prep:
        kind, row = src_of(plane)
        base, ntx = wh_base[hidx]
        flat0 = (base + (y >> 3) * ntx + (x >> 3)) * 64
        wprep_cols[kind].append(
            (row, dy, dx, abcd[0], abcd[1], abcd[2], abcd[3], mx, my,
             flat0, 8, 8)
        )
    _pack_slot(blob, hdr, "wprepY", wprep_cols[0], NWARP)
    _pack_slot(blob, hdr, "wprepC", wprep_cols[1], NWARP)

    # --- host-computed preps (rare: bilinear compound) ---
    host_rows = []
    host_tiles = []

    def host_pool_rows(arr):
        nonlocal npool
        h, w = arr.shape
        ntx = (w + 7) >> 3
        nty = (h + 7) >> 3
        base = npool
        a = np.zeros((nty * 8, ntx * 8), np.int32)
        a[:h, :w] = arr
        for ty in range(nty):
            for tx in range(ntx):
                host_rows.append(base + ty * ntx + tx)
                host_tiles.append(a[ty * 8 : ty * 8 + 8, tx * 8 : tx * 8 + 8])
        npool += ntx * nty
        return (base, ntx)

    def rows_of(s):
        if isinstance(s, _PrepHandle):
            return pool_rows[("p", s.idx)]
        if isinstance(s, _WarpPrepHandle):
            return pool_rows[("w", s.idx)]
        return host_pool_rows(np.asarray(s, np.int32))

    # --- compound combine tiles ---
    hmask_parts = []
    hmask_off = 0
    comb = {"avg": [], "mask": [], "seguv": [],
            "segy00": [], "segy10": [], "segy11": []}
    seg_off = {}
    mask_off = 0
    for rec in jobs.recs:
        kind, pl, dy, dx, w, h, s0, s1, extra = rec
        (b0, ntx0) = rows_of(s0)
        (b1, ntx1) = rows_of(s1)
        flat00 = pl * psz + dy * aw + dx
        for ty in range(0, h, 8):
            th = min(8, h - ty)
            for tx in range(0, w, 8):
                tw = min(8, w - tx)
                r0 = b0 + (ty >> 3) * ntx0 + (tx >> 3)
                r1 = b1 + (ty >> 3) * ntx1 + (tx >> 3)
                flat0 = flat00 + ty * aw + tx
                if kind in ("avg", "wavg"):
                    wt = 8 if kind == "avg" else extra
                    comb["avg"].append((r0, r1, flat0, wt, 0, 0, tw, th))
                elif kind == "mask":
                    moff = hmask_off + ty * w + tx
                    comb["mask"].append((r0, r1, flat0, moff, w, 0, tw, th))
                elif kind == "seg_y":
                    sign, sh_, sv_, seg_id = extra
                    if seg_id not in seg_off:
                        seg_off[seg_id] = (mask_off, w >> sh_, sh_, sv_)
                        mask_off += (w >> sh_) * (h >> sv_)
                    mo, mw, _, _ = seg_off[seg_id]
                    p0 = mo + (ty >> sv_) * mw + (tx >> sh_)
                    comb[f"segy{sh_}{sv_}"].append(
                        (r0, r1, flat0, p0, mw, sign, tw, th)
                    )
                else:  # seg_uv
                    mo, mw, _, _ = seg_off[extra]
                    p0 = mo + ty * mw + tx
                    comb["seguv"].append((r0, r1, flat0, p0, mw, 0, tw, th))
        if kind == "mask":
            m = np.zeros((h, w), np.int32)
            me = np.asarray(extra)
            if me.ndim == 2:
                m[: me.shape[0], : me.shape[1]] = me[:h, :w]
            else:
                m[:, :] = np.broadcast_to(
                    me.reshape(-1)[: h * w].reshape(h, w), (h, w)
                )
            hmask_parts.append(m.reshape(-1))
            hmask_off += h * w
    if npool > POOLROWS or mask_off > psz:
        return None
    for name in ("avg", "mask", "seguv", "segy00", "segy10", "segy11"):
        _pack_slot(blob, hdr, name, comb[name], NCOMB)

    if host_tiles:
        rows = np.asarray(host_rows, np.int32)
        tiles = np.stack(host_tiles).reshape(len(host_rows), 64)
        nh = rows.size
        nc = (nh + HB - 1) // HB
        d = np.full((nc, 65, HB), 0, np.int32)
        d[:, 0, :] = np.concatenate(
            [rows, np.full(nc * HB - nh, 1 << 30, np.int32)]
        ).reshape(nc, HB)
        tp = np.zeros((nc * HB, 64), np.int32)
        tp[:nh] = tiles
        d[:, 1:, :] = tp.reshape(nc, HB, 64).transpose(0, 2, 1)
        hdr[INTER0 + 2 * SLOTS["hostpool"]] = blob.add_words(d)
        hdr[INTER0 + 2 * SLOTS["hostpool"] + 1] = nc

    # --- OBMC blend tiles (tops packed before lefts: recon.rs obmc order)
    omask_off = {}
    blend_cols = {"h": [], "v": []}
    for kind, dst, dy, dx, lap, w, h in jobs.blends:
        di = dstmap[id(dst)]
        base, ntx, nty, lw, lh = lap_rows[id(lap)]
        n = h if kind == "h" else w
        mk = (kind, n)
        if mk not in omask_off:
            vn = (n * 3) >> 2
            vec = np.zeros(n, np.int32)
            vec[:vn] = np.asarray(OBMC_MASKS[n : n + vn], np.int32)
            omask_off[mk] = hmask_off
            hmask_parts.append(vec)
            hmask_off += n
        mo = omask_off[mk]
        for ty in range(0, h, 8):
            th = min(8, h - ty)
            for tx in range(0, w, 8):
                tw = min(8, w - tx)
                flat0 = di * psz + (dy + ty) * aw + (dx + tx)
                if ty < lh and tx < lw:
                    row = base + (ty >> 3) * ntx + (tx >> 3)
                else:
                    row = base  # mask is zero there; any valid row works
                if kind == "h":
                    moff, mrs, mcs = mo + ty, 1, 0
                else:
                    moff, mrs, mcs = mo + tx, 0, 1
                blend_cols[kind].append((row, flat0, moff, mrs, mcs, tw, th))
    if not _skip("obmc"):
        # A chunk's tiles all read pf BEFORE any of the chunk's writes, so
        # overlapping blends must land in different chunks. The only
        # overlaps are a block's own top-lap x left-lap corner (top rows x
        # left cols), so: all top blends, pad to a chunk boundary, then
        # all left blends — left corners then read post-top-blend pixels,
        # exactly the host's per-block h-then-v order.
        hc, nh = _chunked(
            list(np.asarray(blend_cols["h"], np.int32).T), 
            len(blend_cols["h"]), TB,
        ) if blend_cols["h"] else (np.zeros((0, NBLEND, TB), np.int32), 0)
        vc, nv = _chunked(
            list(np.asarray(blend_cols["v"], np.int32).T),
            len(blend_cols["v"]), TB,
        ) if blend_cols["v"] else (np.zeros((0, NBLEND, TB), np.int32), 0)
        if nh or nv:
            hdr[INTER0 + 2 * SLOTS["blend"]] = blob.add_words(
                np.concatenate([hc, vc])
            )
            hdr[INTER0 + 2 * SLOTS["blend"] + 1] = nh + nv

    if hmask_parts:
        hdr[IH0] = blob.add_words(np.concatenate(hmask_parts))
    return srcsY, srcsC


# ------------------------------- filters ---------------------------------


def _skip(stage):
    """RAV1D_ENGINE_SKIP=deblock,cdef,lr,resid,wave,inter — debugging aid:
    zero the stage's descriptor counts/maps (traced data, so no recompile)
    to bisect engine-vs-host mismatches per stage."""
    return stage in os.environ.get("RAV1D_ENGINE_SKIP", "").split(",")


def _pack_deblock(f, blob, hdr):
    """Byte-packed final class|level maps (host-resolved: neighbour-level
    fallback + tile fixups; lf_apply.rs:597). Absent deblock points at a
    zeroed region (level 0 = no-op)."""
    from ..headers import PixelLayout
    from ..ops.ref.lf import calc_eih
    from ..recon.lf import _fix_tile_cols

    frame_hdr = f.frame_hdr
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    h4, w4 = f.bh, f.bw
    ch4 = (f.bh + ss_ver) >> ss_ver
    cw4 = (f.bw + ss_hor) >> ss_hor
    e_lut, i_lut = calc_eih(frame_hdr.loopfilter.sharpness)
    hdr[DB0] = blob.add_words(
        np.stack([np.asarray(e_lut, np.int32), np.asarray(i_lut, np.int32)])
    )
    have_y = frame_hdr.loopfilter.level_y != [0, 0]
    have_uv = (
        layout != PixelLayout.I400
        and (frame_hdr.loopfilter.level_u or frame_hdr.loopfilter.level_v)
    )
    if _skip("deblock"):
        have_y = have_uv = False
    if have_y or have_uv:
        _fix_tile_cols(f)

    def resolve(cls_map, comp, nh4, nw4, horizontal):
        cm = np.asarray(cls_map[:nh4, :nw4], np.int64)
        lv = f.lf_level[:nh4, :nw4, comp].astype(np.int64)
        lprev = np.zeros_like(lv)
        if horizontal:
            lprev[1:, :] = lv[:-1, :]
            lv = np.where(lv != 0, lv, lprev)
            lv[0, :] = 0
        else:
            lprev[:, 1:] = lv[:, :-1]
            lv = np.where(lv != 0, lv, lprev)
            lv[:, 0] = 0
        cm = np.where(lv != 0, cm, 0)
        if horizontal:
            cm, lv = cm.T, lv.T  # the kernel transposes the plane
        return blob.add_u8(((cm << 6) | lv).astype(np.uint8))

    sizes = [h4 * w4, ch4 * cw4, ch4 * cw4] * 2
    for i in range(6):
        hor = i >= 3
        chroma = (i % 3) != 0
        have = have_uv if chroma else have_y
        if not have:
            hdr[DB0 + 1 + i] = blob.alloc_zeros((sizes[i] + 3) // 4)
            continue
        if not chroma:
            hdr[DB0 + 1 + i] = resolve(f.lf_cls[1 if hor else 0],
                                       1 if hor else 0, h4, w4, hor)
        else:
            comp = 2 if (i % 3) == 1 else 3
            hdr[DB0 + 1 + i] = resolve(f.lf_cls[3 if hor else 2], comp,
                                       ch4, cw4, hor)


def _pack_cdef(f, blob, hdr):
    """Per-8x8 cdef level maps as bytes (cdef_apply.rs:159 strengths);
    absent cdef = zeroed maps (no-op)."""
    frame_hdr = f.frame_hdr
    cdef = frame_hdr.cdef
    bw, bh = f.bw, f.bh
    nby, nbx = (bh + 1) >> 1, (bw + 1) >> 1
    hdr[CDEF0 + 2] = cdef.damping + (f.cur.bpc - 8)
    active = any(
        cdef.y_strength[i] or cdef.uv_strength[i]
        for i in range(1 << cdef.n_bits)
    ) and not _skip("cdef")
    if not active:
        hdr[CDEF0] = blob.alloc_zeros((nby * nbx + 3) // 4)
        hdr[CDEF0 + 1] = blob.alloc_zeros((nby * nbx + 3) // 4)
        return
    noskip = f.noskip8[:nby, :nbx] != 0
    cdef_idx = f.cdef_idx[
        (np.arange(nby)[:, None] * 2) >> 4, (np.arange(nbx)[None, :] * 2) >> 4
    ].astype(np.int64)
    ok = (cdef_idx >= 0) & noskip
    y_str = np.asarray(cdef.y_strength, np.int64)
    uv_str = np.asarray(cdef.uv_strength, np.int64)
    y_lvl = np.where(ok, y_str[np.maximum(cdef_idx, 0)], 0)
    uv_lvl = np.where(ok, uv_str[np.maximum(cdef_idx, 0)], 0)
    keep = (y_lvl != 0) | (uv_lvl != 0)
    y_lvl = np.where(keep, y_lvl, 0)
    uv_lvl = np.where(keep, uv_lvl, 0)
    hdr[CDEF0] = blob.add_u8(y_lvl.astype(np.uint8))
    hdr[CDEF0 + 1] = blob.add_u8(uv_lvl.astype(np.uint8))


def _collect_lr(f):
    """Walk the LR unit grid exactly like recon/lr_apply.py apply_lr and
    collect per-stripe descriptors grouped by (kind, plane)
    (lr_apply.rs:261). Returns (groups, (Wy, Wc))."""
    from ..headers import PixelLayout, RestorationType
    from ..recon.lr_apply import RestorationUnit, restore_planes_mask

    frame_hdr = f.frame_hdr
    restore_planes = restore_planes_mask(frame_hdr)
    if not restore_planes:
        return {}, (96, 96)
    seq_hdr = f.seq_hdr
    sb128 = seq_hdr.sb128
    layout = f.cur.layout
    sr = f.sr_cur
    groups = {}
    ws = [96, 96]

    def emit_stripes(plane_idx, x, y, unit_w, row_h, lr, plane_h, w_plane,
                     ss_ver, Wmax):
        stripe_h = min((64 - 8 * (1 if y == 0 else 0)) >> ss_ver, row_h - y)
        have_left = x > 0
        have_top = y > 0
        sby_cur = (y + ((8 << ss_ver) if y else 0)) >> (6 - ss_ver + sb128)
        while y + stripe_h <= row_h:
            have_bottom = sby_cur + 1 != f.sbh or y + stripe_h != row_h
            have_right = x + unit_w < w_plane
            below = y + stripe_h
            below2 = below if below + 1 == plane_h else below + 1
            H = plane_h
            xlo = x - (3 if have_left else 0)
            xhi = x + unit_w - 1 + (3 if have_right else 0)
            if have_top:
                top0 = H + (y - 2)
                top1 = H + (y - 2) + 1
            else:
                top0 = top1 = y
            if have_bottom:
                bot0 = H + below
                bot1 = H + below2
            else:
                bot0 = bot1 = y + stripe_h - 1
            if lr.type == RestorationType.WIENER:
                key = ("w", plane_idx)
                p = (lr.filter_h[0], lr.filter_h[1], lr.filter_h[2],
                     lr.filter_v[0], lr.filter_v[1], lr.filter_v[2])
            else:
                from ..tables.spec_data import SGR_PARAMS

                s0 = int(SGR_PARAMS[lr.sgr_idx][0])
                s1 = int(SGR_PARAMS[lr.sgr_idx][1])
                w0 = lr.sgr_weights[0]
                w1 = 128 - (lr.sgr_weights[0] + lr.sgr_weights[1])
                kind = 2 if (s0 and s1) else (0 if s0 else 1)
                key = (kind, plane_idx)
                p = (s0, s1, w0, w1, 0, 0)
            groups.setdefault(key, []).append(
                (x, y, unit_w, stripe_h, xlo, xhi, top0, top1, bot0, bot1) + p
            )
            y += stripe_h
            have_top = True  # later stripes of a 128px SB row have lpf rows
            stripe_h = min(64 >> ss_ver, row_h - y)
            if stripe_h == 0:
                break

    def walk_plane(plane_idx, w, h, ss_ver, ss_hor):
        unit_size_log2 = frame_hdr.restoration.unit_size[1 if plane_idx else 0]
        unit_size = 1 << unit_size_log2
        half_unit = unit_size >> 1
        max_unit_size = unit_size + half_unit
        ws[1 if plane_idx else 0] = max_unit_size
        shift_hor = 7 - ss_hor
        for sby in range(f.sbh):
            offset = (8 >> ss_ver) if sby else 0
            not_last = 1 if sby + 1 < f.sbh else 0
            next_row_y = (sby + 1) << (6 - ss_ver + sb128)
            row_h = min(next_row_y - (8 >> ss_ver) * not_last, h)
            y_stripe = (sby << (6 - ss_ver + sb128)) - offset
            y = y_stripe
            row_y = y + ((8 >> ss_ver) if y else 0)
            aligned_unit_pos = row_y & ~(unit_size - 1)
            if aligned_unit_pos and aligned_unit_pos + half_unit > h:
                aligned_unit_pos -= unit_size
            aligned_unit_pos <<= ss_ver
            sb_idx = (aligned_unit_pos >> 7) * f.sr_sb128w
            unit_idx = ((aligned_unit_pos >> 6) & 1) << 1

            def get_unit(si, ui):
                u = f.lr_units.get((plane_idx, si, ui))
                return u if u is not None else RestorationUnit()

            lr = [get_unit(sb_idx, unit_idx), None]
            restore = lr[0].type != RestorationType.NONE
            x = 0
            bit = 0
            while x + max_unit_size <= w:
                next_x = x + unit_size
                next_u_idx = unit_idx + ((next_x >> (shift_hor - 1)) & 1)
                lr[1 - bit] = get_unit(sb_idx + (next_x >> shift_hor),
                                       next_u_idx)
                if restore:
                    emit_stripes(plane_idx, x, y, unit_size, row_h, lr[bit],
                                 h, w, ss_ver, max_unit_size)
                x = next_x
                restore = lr[1 - bit].type != RestorationType.NONE
                bit = 1 - bit
            if restore:
                emit_stripes(plane_idx, x, y, w - x, row_h, lr[bit], h, w,
                             ss_ver, max_unit_size)

    if restore_planes & 1:
        walk_plane(0, sr.w, sr.h, 0, 0)
    if layout != PixelLayout.I400 and restore_planes & 6:
        ss_ver = 1 if layout == PixelLayout.I420 else 0
        ss_hor = 1 if layout != PixelLayout.I444 else 0
        cw = (sr.w + ss_hor) >> ss_hor
        ch = (sr.h + ss_ver) >> ss_ver
        if restore_planes & 2:
            walk_plane(1, cw, ch, ss_ver, ss_hor)
        if restore_planes & 4:
            walk_plane(2, cw, ch, ss_ver, ss_hor)
    return groups, (ws[0], ws[1])


_KINDS = ("w", 0, 1, 2)


def _pack_lr(f, blob, hdr):
    if _skip("lr"):
        return (96, 96)
    groups, lr_ws = _collect_lr(f)
    for (kind, pl), cols in groups.items():
        a = np.asarray(cols, np.int32).T  # (16, n)
        d, nc = _chunked(list(a), a.shape[1], LRB)
        slot = 4 * pl + _KINDS.index(kind)
        hdr[LR0 + 2 * slot] = blob.add_words(d)
        hdr[LR0 + 2 * slot + 1] = nc
    # Quantize the per-frame max unit widths to two buckets: lr_ws is a
    # STATIC of filter_prog, and letting it track frame content minted 5
    # filter compile keys in the 140-frame bench stream alone (round-5
    # measured: each costs 35-78 s of compile). The stripe kernels iterate
    # data-driven unit lists, so a wider static W only pads the per-stripe
    # tile; 384 = the largest possible edge-merged unit
    # (unit_size 256 * 3/2, lr_apply.rs:261 max_unit_size).
    Wy, Wc = lr_ws
    return (96 if Wy <= 96 else 384, 96 if Wc <= 96 else 384)


# ------------------------------- execute ---------------------------------


def _stack(srcs, pad_to):
    import jax.numpy as jnp

    from .inter import dev_plane

    rows = [dev_plane(pic, pl) for pic, pl in srcs]
    if not rows:
        return None
    while len(rows) < pad_to:
        rows.append(rows[0])
    return jnp.stack(rows[:pad_to])


_TRACE = os.environ.get("RAV1D_ENGINE_TRACE") == "1"
# RAV1D_ENGINE_TRACE=2: additionally block after each program and report
# per-program device execution time (separates exec from transfer cost)
_TRACE2 = os.environ.get("RAV1D_ENGINE_TRACE") == "2"
# RAV1D_ENGINE_CAPTURE=<dir>: dump each frame's packed blob + program args
# to <dir>/frame<N>.npz for offline per-stage ablation (tools_py/ablate.py)
_CAPTURE = os.environ.get("RAV1D_ENGINE_CAPTURE")
_capture_n = [0]


def _capture_frame(f, plan, blob, hdr, srcs, extra):
    buf = np.zeros(blob.pos, np.int32)
    buf[: hdr.size] = hdr
    for off, a in blob.parts:
        buf[off : off + a.size] = a
    for off, n in blob.zparts:
        buf[off : off + n] = 0
    kw = dict(extra)
    if srcs is not None:
        srcsY, srcsC = srcs
        kw["nsrcY"] = len(srcsY)
        kw["nsrcC"] = len(srcsC)
        for i, (pic, pl) in enumerate(srcsY):
            kw[f"srcY{i}"] = np.asarray((pic.y, pic.u, pic.v)[pl])
        for i, (pic, pl) in enumerate(srcsC):
            kw[f"srcC{i}"] = np.asarray((pic.y, pic.u, pic.v)[pl])
    np.savez_compressed(
        os.path.join(_CAPTURE, "frame%03d.npz" % _capture_n[0]),
        buf=buf, hdr=hdr, **kw,
    )
    _capture_n[0] += 1

# cumulative per-stage wall time (ms) across all engine frames of the
# process — the bench and chip_smoke.py report this split
stage_ms = {"pack": 0.0, "upload": 0.0, "programs": 0.0, "fetch": 0.0}

# ---------------------------------------------------------------------------
# Batched deferred fetch.
#
# execute() leaves each frame's packed output ON DEVICE and registers the
# picture here; flush_fetches() stacks every pending output with one traced
# concat and brings them home in ONE device-to-host transfer per batch. The
# decoder provides the lookahead that makes batches possible: engine mode
# delays picture output by a frame ring as dav1d's out_delayed ring does
# (src/lib.rs:160-164, n_fc frames in flight before the first output).
# Whether batching still pays on a directly attached card is not measured
# yet; everything here runs on the thread that dispatches the programs.
# ---------------------------------------------------------------------------

_PENDING = []  # pictures whose packed output is still device-resident
FETCH_BATCH = int(os.environ.get("RAV1D_FETCH_BATCH", "8"))
# Frames left in flight when a batch flush triggers: the flush's blocking
# asarray then waits only on the OLDEST K frames while the newest LAG
# frames keep the device busy behind it, instead of draining the whole
# device queue while the host packs the next batch.
FETCH_LAG = int(os.environ.get("RAV1D_FETCH_LAG", "4"))


def flush_fetches(count=None):
    """Materialize pending device-resident outputs (the `count` oldest;
    default all): one jnp.stack dispatch + one d2h transfer per packed
    geometry group."""
    global _PENDING
    if not _PENDING:
        return
    import time

    import jax.numpy as jnp

    if count is None or count >= len(_PENDING):
        pend, _PENDING = _PENDING, []
    else:
        pend, _PENDING = _PENDING[:count], _PENDING[count:]
    t0 = time.perf_counter()
    groups = {}
    for pic in pend:
        p = getattr(pic, "_pending_fetch", None)
        if p is None or isinstance(p[0], np.ndarray):
            continue
        groups.setdefault((p[0].shape, str(p[0].dtype)), []).append(pic)
    for _, pics in groups.items():
        if len(pics) == 1:
            flats = [np.asarray(pics[0]._pending_fetch[0])]
        else:
            flats = list(
                np.asarray(jnp.stack([p._pending_fetch[0] for p in pics]))
            )
        for pic, flat in zip(pics, flats):
            _, psz, ah, aw, ach, acw = pic._pending_fetch
            pic._pending_fetch = None
            pic.y[:, :] = flat[:psz].reshape(ah, aw)
            if pic.u is not None:
                csz = ach * acw
                pic.u[:, :] = flat[psz : psz + csz].reshape(ach, acw)
                pic.v[:, :] = flat[psz + csz :].reshape(ach, acw)
    stage_ms["fetch"] += (time.perf_counter() - t0) * 1e3
    if _TRACE:
        print(
            "[engine] flush_fetches %d pics %.1f ms"
            % (len(pend), (time.perf_counter() - t0) * 1e3),
            flush=True,
        )


def execute(f, plan):
    """Run the dense pass on the device. Returns False when a pool capacity
    would overflow (host fallback), True on success."""
    import time

    from ..headers import PixelLayout

    t0 = time.perf_counter()
    ah, aw = plan.ah, plan.aw
    psz = ah * aw
    bpc = f.cur.bpc
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    store = f.coef_store

    hdr = np.zeros(HDR_LEN, np.int32)
    blob = FrameBlob(HDR_LEN)

    if store.tx_pos:
        cf = store.cf[: store.cf_pos]
        hdr[CF0] = blob.add_i16(cf) if bpc == 8 else blob.add_words(cf)

    _pack_residuals(blob, hdr, store, plan, psz, aw)
    srcs = None
    if plan.inter is not None:
        srcs = _plan_inter_v3(f, plan, blob, hdr, psz, aw)
        if srcs is None:
            return False
    _pack_palette(blob, hdr, plan, psz, aw)
    _pack_wave(blob, hdr, plan, psz, aw)
    _pack_deblock(f, blob, hdr)
    _pack_cdef(f, blob, hdr)
    need_sr = f.frame_hdr.size.width[0] != f.frame_hdr.size.width[1]
    if need_sr:
        for ci in range(2):
            hdr[SR0 + 2 * ci] = f.resize_step[ci]
            hdr[SR0 + 2 * ci + 1] = f.resize_start[ci]
    lr_ws = _pack_lr(f, blob, hdr)
    t_pack = time.perf_counter()

    if _CAPTURE:
        need_sr_ = f.frame_hdr.size.width[0] != f.frame_hdr.size.width[1]
        _capture_frame(
            f, plan, blob, hdr, srcs,
            dict(ah=ah, aw=aw, bpc=bpc, layout=int(layout),
                 ss_hor=ss_hor, ss_ver=ss_ver, lr_ws=np.asarray(lr_ws),
                 need_sr=int(need_sr_), w=f.cur.w, h=f.cur.h,
                 bw=f.bw, bh=f.bh),
        )

    dev, _cap = blob.upload(hdr, hwm_key=(ah, aw, bpc, int(layout)),
                            floor=det_cap_words(psz, bpc))
    t_up = time.perf_counter()

    def _t2(tag, val):
        if _TRACE2:
            import time as _time

            import jax

            t = _time.perf_counter()
            jax.block_until_ready(val)
            print("[engine2] %s %.1f ms" % (tag, (_time.perf_counter() - t) * 1e3),
                  flush=True)

    _t2("upload-sync", dev)
    ra, planes = prog("resid", resid_prog,
                      dict(ah=ah, aw=aw, bpc=bpc), (dev,))(dev)
    _t2("resid", planes)
    if srcs is not None:
        srcsY, srcsC = srcs
        stackY = _stack(srcsY, 8)
        stackC = _stack(srcsC, 16)
        if stackY is None:
            stackY = __import__("jax.numpy", fromlist=["zeros"]).zeros(
                (8, ah, aw), planes.dtype
            )
        if stackC is None:
            stackC = stackY[:1]
        vwC = (f.cur.w + ss_hor) >> ss_hor
        vhC = (f.cur.h + ss_ver) >> ss_ver
        planes = prog(
            "inter", inter_prog,
            dict(ah=ah, aw=aw, bpc=bpc, vwY=f.cur.w, vhY=f.cur.h,
                 vwC=vwC, vhC=vhC),
            (planes, ra, dev, stackY, stackC),
        )(planes, ra, dev, stackY, stackC)
        _t2("inter", planes)
    planes = prog(
        "wave", wave_prog,
        dict(ah=ah, aw=aw, bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver),
        (planes, ra, dev),
    )(planes, ra, dev)
    _t2("wave", planes)

    out_pic = f.sr_cur
    if out_pic.u is not None:
        ach, acw = out_pic.u.shape
    else:
        ach = acw = 0
    if need_sr:
        s_ah, s_aw = out_pic.y.shape
        sr_geom = (s_ah, s_aw, out_pic.w, out_pic.h, 4 * f.bw)
    else:
        s_ah, s_aw = ah, aw
        sr_geom = None
    geom = (ah, aw, ach, acw, f.bh, f.bw, f.cur.h)
    dev_out, packed = prog(
        "filter", filter_prog,
        dict(geom=geom, bpc=bpc, layout_i=int(layout),
             need_sr=need_sr, sr_geom=sr_geom, lr_ws=lr_ws),
        (planes, dev),
    )(planes, dev)
    _t2("filter", packed)

    out_pic._dev_planes = {0: dev_out[0]}
    if out_pic.u is not None:
        out_pic._dev_planes[1] = dev_out[1, :ach, :acw]
        out_pic._dev_planes[2] = dev_out[2, :ach, :acw]
    # DEFER the fetch: leave the packed output device-resident and
    # register it for the next flush_fetches() batch (see the note at the
    # registry above). RAV1D_FETCH_BATCH=1 fetches every frame on its own.
    t_prog = time.perf_counter()
    out_pic._pending_fetch = (packed, s_ah * s_aw, s_ah, s_aw, ach, acw)
    _PENDING.append(out_pic)
    if len(_PENDING) >= FETCH_BATCH + FETCH_LAG:
        flush_fetches(len(_PENDING) - FETCH_LAG)
    t_end = time.perf_counter()
    stage_ms["pack"] += (t_pack - t0) * 1e3
    stage_ms["upload"] += (t_up - t_pack) * 1e3
    stage_ms["programs"] += (t_prog - t_up) * 1e3
    # fetch time is accounted inside flush_fetches (batched across frames)
    if _TRACE:
        print(
            "[engine] pack %.1f up %.1f prog %.1f fetch %.1f ms "
            "(blob %d KB, cap %d KB)"
            % (
                (t_pack - t0) * 1e3, (t_up - t_pack) * 1e3,
                (t_prog - t_up) * 1e3, (t_end - t_prog) * 1e3,
                blob.pos * 4 // 1024, _cap * 4 // 1024,
            ),
            flush=True,
        )
    return True
