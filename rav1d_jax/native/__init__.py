"""ctypes bindings for the native entropy core (native/entropy.c).

The shared library is built on demand with the system C compiler and cached
next to the source; set RAV1D_NO_NATIVE=1 to force the pure-Python
entropy plane (the correctness anchor the C core is validated against).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "..", "native", "entropy.c")
_SO = os.path.join(_HERE, "..", "..", "native", "libentropy.so")


class MsacState(ctypes.Structure):
    _fields_ = [
        ("buf", ctypes.c_void_p),
        ("pos", ctypes.c_size_t),
        ("end", ctypes.c_size_t),
        ("dif", ctypes.c_uint64),
        ("rng", ctypes.c_uint32),
        ("cnt", ctypes.c_int32),
        ("allow_update", ctypes.c_int32),
    ]


class CoefCdfPtrs(ctypes.Structure):
    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "skip", "eob_bin_16", "eob_bin_32", "eob_bin_64", "eob_bin_128",
            "eob_bin_256", "eob_bin_512", "eob_bin_1024", "eob_hi_bit",
            "eob_base_tok", "base_tok", "br_tok", "dc_sign",
        )
    ]


class CoefCallParams(ctypes.Structure):
    _fields_ = [
        ("tdim_lw", ctypes.c_int32),
        ("tdim_lh", ctypes.c_int32),
        ("tdim_w", ctypes.c_int32),
        ("tdim_h", ctypes.c_int32),
        ("tdim_ctx", ctypes.c_int32),
        ("tdim_min", ctypes.c_int32),
        ("tdim_max", ctypes.c_int32),
        ("bdim_lw", ctypes.c_int32),
        ("bdim_lh", ctypes.c_int32),
        ("chroma", ctypes.c_int32),
        ("ss_ver", ctypes.c_int32),
        ("ss_hor", ctypes.c_int32),
        ("ctx_off_idx", ctypes.c_int32),
        ("txtp_mode", ctypes.c_int32),
        ("txtp_fixed", ctypes.c_int32),
        ("skip_txtp", ctypes.c_int32),
        ("idtx_val", ctypes.c_int32),
        ("txtp_cdf", ctypes.c_void_p),
        ("dq_dc", ctypes.c_int32),
        ("dq_ac", ctypes.c_int32),
        ("dq_shift", ctypes.c_int32),
        ("cf_max", ctypes.c_int32),
        ("a", ctypes.c_void_p),
        ("a_off", ctypes.c_int32),
        ("l", ctypes.c_void_p),
        ("l_off", ctypes.c_int32),
        ("skip_ctx_tbl", ctypes.c_void_p),
        ("lo_ctx_offsets", ctypes.c_void_p),
        ("tx_types_per_set", ctypes.c_void_p),
        ("tx_type_class", ctypes.c_void_p),
        ("scan", ctypes.c_void_p),
        ("qm", ctypes.c_void_p),
        ("cf", ctypes.c_void_p),
        ("eob", ctypes.c_int32),
        ("txtp", ctypes.c_int32),
        ("cf_ctx", ctypes.c_int32),
    ]


def build_so(srcs, so, flags) -> str | None:
    """Compile `srcs` into the shared library `so` unless it is newer than
    every source. Concurrent importers (test workers) serialize on a lock
    file, and the library appears atomically, so none loads a partial
    file. Returns None when a source is missing or the build fails."""
    import fcntl

    srcs = [os.path.normpath(s) for s in srcs]
    so = os.path.normpath(so)
    if not all(os.path.exists(s) for s in srcs):
        return None

    def fresh():
        return os.path.exists(so) and all(
            os.path.getmtime(so) >= os.path.getmtime(s) for s in srcs
        )

    if fresh():
        return so
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not fresh():
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = [os.environ.get("CC", "cc"), *flags, "-shared", "-fPIC",
                   "-o", tmp, *srcs]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except (subprocess.CalledProcessError, FileNotFoundError):
                return None
            os.replace(tmp, so)
    return so


def _build(src=_SRC, so=_SO) -> str | None:
    return build_so([src], so, ["-O3", "-fvisibility=hidden"])


class RefMvsCall(ctypes.Structure):
    _fields_ = [
        ("r", ctypes.c_void_p),
        ("r_stride", ctypes.c_int32),
        ("rp_proj", ctypes.c_void_p),
        ("rp_stride", ctypes.c_int32),
        ("bdims", ctypes.c_void_p),
        ("pocdiff", ctypes.c_int32 * 7),
        ("sign_bias", ctypes.c_int32 * 7),
        ("use_ref_frame_mvs", ctypes.c_int32),
        ("iw4", ctypes.c_int32),
        ("ih4", ctypes.c_int32),
        ("col_start", ctypes.c_int32),
        ("col_end", ctypes.c_int32),
        ("row_start", ctypes.c_int32),
        ("row_end", ctypes.c_int32),
        ("bs", ctypes.c_int32),
        ("bw4", ctypes.c_int32),
        ("bh4", ctypes.c_int32),
        ("bx4", ctypes.c_int32),
        ("by4", ctypes.c_int32),
        ("ref0", ctypes.c_int32),
        ("ref1", ctypes.c_int32),
        ("edge_has_tr", ctypes.c_int32),
        ("force_integer_mv", ctypes.c_int32),
        ("hp", ctypes.c_int32),
        ("use_rfm_hdr", ctypes.c_int32),
        ("gmv", (ctypes.c_int32 * 2) * 2),
        ("tgmv", (ctypes.c_int32 * 2) * 2),
        ("out_mv", ((ctypes.c_int16 * 2) * 2) * 8),
        ("out_weight", ctypes.c_int32 * 8),
        ("out_cnt", ctypes.c_int32),
        ("out_ctx", ctypes.c_int32),
    ]


def _load_refmvs():
    if os.environ.get("RAV1D_NO_NATIVE"):
        return None
    src = os.path.join(_HERE, "..", "..", "native", "refmvs.c")
    so = os.path.join(_HERE, "..", "..", "native", "librefmvs.so")
    built = _build(src, so)
    if built is None:
        return None
    try:
        lib = ctypes.CDLL(built)
    except OSError:
        return None
    lib.dav1d_refmvs_find.argtypes = [ctypes.POINTER(RefMvsCall)]
    lib.dav1d_refmvs_find.restype = None
    return lib


def _load():
    if os.environ.get("RAV1D_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    P = ctypes.POINTER
    lib.msac_init.argtypes = [
        P(MsacState), ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.msac_init.restype = None
    lib.msac_decode_bool_equi.argtypes = [P(MsacState)]
    lib.msac_decode_bool_equi.restype = ctypes.c_uint32
    lib.msac_decode_bool.argtypes = [P(MsacState), ctypes.c_uint32]
    lib.msac_decode_bool.restype = ctypes.c_uint32
    lib.msac_decode_bool_adapt.argtypes = [P(MsacState), ctypes.c_void_p]
    lib.msac_decode_bool_adapt.restype = ctypes.c_uint32
    lib.msac_decode_symbol_adapt.argtypes = [
        P(MsacState), ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.msac_decode_symbol_adapt.restype = ctypes.c_uint32
    lib.msac_decode_hi_tok.argtypes = [P(MsacState), ctypes.c_void_p]
    lib.msac_decode_hi_tok.restype = ctypes.c_uint32
    lib.msac_decode_bools.argtypes = [P(MsacState), ctypes.c_uint32]
    lib.msac_decode_bools.restype = ctypes.c_uint32
    lib.msac_decode_uniform.argtypes = [P(MsacState), ctypes.c_uint32]
    lib.msac_decode_uniform.restype = ctypes.c_uint32
    lib.msac_decode_subexp.argtypes = [
        P(MsacState), ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
    ]
    lib.msac_decode_subexp.restype = ctypes.c_int32
    lib.dav1d_decode_coefs.argtypes = [
        P(MsacState), P(CoefCdfPtrs), P(CoefCallParams),
    ]
    lib.dav1d_decode_coefs.restype = None
    return lib


LIB = _load()
AVAILABLE = LIB is not None


LIB_REFMVS = _load_refmvs()
