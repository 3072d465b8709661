#!/usr/bin/env python
"""Extract AV1 numeric normative tables (scans, dequant, DSP filter
coefficients, grain PRNG sequence) into rav1d_jax/tables/spec_tables.npz.

Like the default CDFs, these are specification data identical in every
conforming AV1 decoder (spec sections 5.9.x / 7.x lookup tables; also in
libaom). We parse them from the rav1d source copy in this environment.
"""

import ast
import re

import numpy as np


def grab_array(text: str, name: str, dtype=np.int32):
    """Find `static NAME: ... = [Align(]([..]))` and parse the literal."""
    m = re.search(rf"static {re.escape(name)}\s*:[^=]+=\s*(?:Align\d+\s*\()?", text)
    if not m:
        raise KeyError(name)
    i = text.index("[", m.end())
    depth = 0
    j = i
    while True:
        if text[j] == "[":
            depth += 1
        elif text[j] == "]":
            depth -= 1
            if depth == 0:
                break
        j += 1
    lit = text[i : j + 1]
    lit = re.sub(r"//[^\n]*", "", lit)  # strip comments
    return np.array(ast.literal_eval(lit), dtype=dtype)


def main():
    out = {}

    # scan orders (src/scan.rs): named scan_WxH; assemble per RectTxfmSize
    with open("/root/reference/src/scan.rs") as f:
        scan_src = f.read()
    for name in [
        "scan_4x4", "scan_4x8", "scan_4x16", "scan_8x4", "scan_8x8",
        "scan_8x16", "scan_8x32", "scan_16x4", "scan_16x8", "scan_16x16",
        "scan_16x32", "scan_32x8", "scan_32x16", "scan_32x32",
    ]:
        out[name] = grab_array(scan_src, name, np.uint16)

    # dequant lookup (src/dequant_tables.rs): [3 bitdepths][256 qidx][dc,ac]
    with open("/root/reference/src/dequant_tables.rs") as f:
        dq_src = f.read()
    out["dq_tbl"] = grab_array(dq_src, "dav1d_dq_tbl", np.uint16)

    # DSP coefficient tables (src/tables.rs)
    with open("/root/reference/src/tables.rs") as f:
        t_src = f.read()
    for name, key, dt in [
        ("dav1d_mc_subpel_filters", "mc_subpel_filters", np.int8),
        ("dav1d_mc_warp_filter", "mc_warp_filter", np.int8),
        ("dav1d_resize_filter", "resize_filter", np.int8),
        ("dav1d_sm_weights", "sm_weights", np.uint8),
        ("dav1d_dr_intra_derivative", "dr_intra_derivative", np.uint16),
        ("dav1d_obmc_masks", "obmc_masks", np.uint8),
        ("dav1d_gaussian_sequence", "gaussian_sequence", np.int16),
        ("dav1d_sgr_x_by_x", "sgr_x_by_x", np.uint8),
        ("dav1d_sgr_params", "sgr_params", np.uint16),
    ]:
        out[key] = grab_array(t_src, name, dt)

    # filter_intra taps: 5 filters x 8 positions x 7 taps, written via the
    # f!() macro; extract the invocation args as a [5][8][7] tensor.
    fit = np.zeros((5, 8, 7), dtype=np.int8)
    block = t_src[
        t_src.index("pub static dav1d_filter_intra_taps") : t_src.index(
            "pub static dav1d_obmc_masks"
        )
    ]
    filt = -1
    for mm in re.finditer(r"let mut array|f!\(\s*array\s*,\s*([^)]+)\)", block):
        if mm.group(0).startswith("let"):
            filt += 1
            continue
        nums = [int(x.strip()) for x in mm.group(1).split(",")]
        idx, taps = nums[0], nums[1:]
        fit[filt, idx] = taps
    out["filter_intra_taps"] = fit

    # cdef directions contain arithmetic (1 * 12 + 0): eval via regex sum
    m = re.search(r"static dav1d_cdef_directions[^=]+=\s*\[", t_src)
    i = t_src.index("[", m.end() - 1)
    depth = 0
    j = i
    while True:
        if t_src[j] == "[":
            depth += 1
        elif t_src[j] == "]":
            depth -= 1
            if depth == 0:
                break
        j += 1
    lit = re.sub(r"//[^\n]*", "", t_src[i : j + 1])
    out["cdef_directions"] = np.array(eval(lit), dtype=np.int8)  # noqa: S307 — arithmetic-only literal

    # quantizer-matrix base tables (src/qm.rs): [15 qm levels][2 planes][N]
    with open("/root/reference/src/qm.rs") as f:
        qm_src = f.read()
    for name in [
        "qm_tbl_4x4_t", "qm_tbl_8x4", "qm_tbl_8x8_t", "qm_tbl_16x4",
        "qm_tbl_16x8", "qm_tbl_32x8", "qm_tbl_32x16", "qm_tbl_32x32_t",
    ]:
        out[name] = grab_array(qm_src, name, np.uint8)

    np.savez_compressed("rav1d_jax/tables/spec_tables.npz", **out)
    print(f"wrote {len(out)} tables")
    for k in sorted(out):
        print(f"  {k}: {out[k].shape} {out[k].dtype}")


if __name__ == "__main__":
    main()
