"""Shared test/tool helpers: full-stream decode to an MD5 of the raw planes
(the meson oracle digest, tools/output/md5.rs semantics) with an optional
engine/numpy path override and a hard per-frame limit."""

from __future__ import annotations

import hashlib
import os


def decode_md5(path, engine=None, limit=0, apply_grain=True):
    """Decode `path` and return (md5_hexdigest, n_frames).

    engine: None = leave RAV1D_ENGINE untouched; True/False = force the
    device engine / numpy path for the duration of the call, restoring any
    pre-existing RAV1D_ENGINE value afterwards. limit: stop after exactly N
    frames (0 = whole stream) — enforced per frame, including drain.
    """
    prev = os.environ.get("RAV1D_ENGINE")
    if engine is not None:
        os.environ["RAV1D_ENGINE"] = "jax" if engine else "np"
    try:
        from rav1d_jax.decoder import Decoder, EAgain, Settings
        from rav1d_jax.io.ivf import IvfDemuxer

        dec = Decoder(Settings(apply_grain=apply_grain))
        md5 = hashlib.md5()
        n = 0

        def write(pic):
            nonlocal n
            for chunk in pic.iter_plane_rows():
                md5.update(chunk)
            n += 1

        done = False
        for pkt in IvfDemuxer(path):
            dec.send_data(pkt.data, pkt.timestamp)
            while not done:
                try:
                    write(dec.get_picture())
                except EAgain:
                    break
                if limit and n >= limit:
                    done = True
            if done:
                break
        while not done:
            try:
                write(dec.get_picture())
            except EAgain:
                break
            if limit and n >= limit:
                done = True
        return md5.hexdigest(), n
    finally:
        if engine is not None:
            if prev is None:
                os.environ.pop("RAV1D_ENGINE", None)
            else:
                os.environ["RAV1D_ENGINE"] = prev
