#!/usr/bin/env python
"""Divergence finder between the native syntax pass and the Python anchor.

Decodes a stream twice in one process, once with the C syntax pass
(native/syntax.c) and once with the Python anchor (syntax/decode.py with
the Python msac and coefficient reader), and
compares the per-block work-item stream, coefficient-store cursors and
per-frame syntax products; prints the first divergence.

    python tools_py/dual_check.py <file.ivf> [frames]
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

NAMES = ["poc", "kind", "bx", "by", "bs", "intra", "skip", "skip_mode",
         "seg_id", "y_mode", "uv_mode", "tx", "uvtx", "max_ytx",
         "tx_split0", "tx_split1", "inter_mode", "drl_idx", "ref", "mv",
         "comp_type", "motion_mode", "filter2d", "interintra_type",
         "wedge_idx", "mask_sign", "y_angle", "uv_angle", "cfl_alpha",
         "tx_pos", "cf_pos", "edge_flags"]


def _h(arr) -> str:
    return hashlib.md5(np.ascontiguousarray(arr).tobytes()).hexdigest()[:12]


def _rows(f):
    store = f.coef_store
    poc = f.frame_hdr.frame_offset
    for wi in f.work_items:
        b = wi.b
        yield [poc, wi.kind, wi.bx, wi.by, int(wi.bs), b.intra, b.skip,
               b.skip_mode, b.seg_id, b.y_mode, b.uv_mode, b.tx, b.uvtx,
               b.max_ytx, b.tx_split0, b.tx_split1, b.inter_mode, b.drl_idx,
               [int(v) for v in b.ref], [[int(v) for v in m] for m in b.mv],
               b.comp_type, b.motion_mode, b.filter2d, b.interintra_type,
               b.wedge_idx, b.mask_sign, b.y_angle, b.uv_angle,
               [int(v) for v in b.cfl_alpha], wi.tx_pos, int(wi.cf_pos),
               wi.intra_edge_flags]
    yield ["STATE", poc, store.tx_pos, int(store.cf_pos),
           _h(store.eob[: store.tx_pos]), _h(store.txtp[: store.tx_pos]),
           _h(store.cf[: store.cf_pos]), _h(f.cdef_idx), _h(f.noskip4),
           sorted((k, u.type, list(u.filter_v), list(u.filter_h),
                   list(u.sgr_weights)) for k, u in f.lr_units.items())]


def work_item_rows(data: bytes, native: bool, limit: int = 0) -> list:
    """Decode `data` (IVF bytes) on the host and return one row per work
    item plus a STATE row per frame; stops at the first decode error, which
    becomes the last row."""
    from rav1d_jax.decoder import Decoder, EAgain, Settings
    from rav1d_jax.io.ivf import IvfDemuxer
    from rav1d_jax.native import syntax as nsy
    from rav1d_jax.entropy.msac import PyMsacContext
    from rav1d_jax.recon import frame as fr
    from rav1d_jax.syntax import decode as sd

    rows = []
    orig = fr.decode_frame_dense

    def hook(f):
        fr.materialize_work_items(f)
        rows.extend(_rows(f))
        return orig(f)

    saved = nsy.FORCE_OFF, os.environ.get("RAV1D_ENGINE"), sd.TILE_MSAC
    nsy.FORCE_OFF = not native
    if not native:  # the anchor end to end: Python msac and coefficients
        sd.TILE_MSAC = lambda data, dis, cdf: PyMsacContext(data, dis)
    os.environ["RAV1D_ENGINE"] = "np"
    fr.decode_frame_dense = hook
    try:
        dec = Decoder(Settings(apply_grain=False, n_threads=1))
        for i, pkt in enumerate(IvfDemuxer(data)):
            if limit and i >= limit:
                break
            try:
                dec.send_data(pkt.data, pkt.timestamp)
            except Exception as e:
                rows.append(["EXC", repr(e)])
                break
            with contextlib.suppress(EAgain):
                dec.get_picture()
    finally:
        fr.decode_frame_dense = orig
        nsy.FORCE_OFF, sd.TILE_MSAC = saved[0], saved[2]
        if saved[1] is None:
            os.environ.pop("RAV1D_ENGINE", None)
        else:
            os.environ["RAV1D_ENGINE"] = saved[1]
    return rows


def first_divergence(a: list, b: list):
    """Index and description of the first differing row, or None."""
    for i, (ra, rb) in enumerate(zip(a, b)):
        if ra != rb:
            if ra and rb and ra[0] not in ("STATE", "EXC") \
                    and rb[0] not in ("STATE", "EXC"):
                diff = {n: (x, y) for n, x, y in zip(NAMES, ra, rb) if x != y}
                return i, f"block at {dict(zip(NAMES[:5], ra[:5]))}: {diff}"
            return i, f"native={str(ra)[:300]} python={str(rb)[:300]}"
    if len(a) != len(b):
        return min(len(a), len(b)), f"row count native {len(a)} python {len(b)}"
    return None


def main():
    data = open(sys.argv[1], "rb").read()
    limit = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    a = work_item_rows(data, True, limit)
    b = work_item_rows(data, False, limit)
    d = first_divergence(a, b)
    print("identical, %d rows" % len(a) if d is None
          else "first divergence at row %d: %s" % d)


if __name__ == "__main__":
    main()
