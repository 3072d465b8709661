"""Decode-driven stream generation.

The Python syntax anchor (`syntax/decode.py`) already walks every symbol a
frame holds. Generation runs that walk on a private `Decoder` with each
tile's msac context replaced by a `SymbolChooser`, so the walk *chooses*
the symbols (from the CDFs it passes in, with a seeded generator) instead
of reading them. The chooser's record is then range-coded by `MsacEncoder`
into the tile payload, and the frame is written with the same header.
Because parsing never depends on pixels, the dense pass is skipped.

Two biases keep block counts and generation time bounded (everything else
follows the CDFs):

- partition depth: a partition symbol is forced to PARTITION_NONE with
  probability `_PARTITION_NONE_P`;
- coefficient skip: a transform block's all-zero flag is forced on with
  probability `_COEF_SKIP_P`.

The oracle is the decoder itself: the generator proves that what it writes
decodes back to what it chose (round-trip consistency), not that the
decoder conforms to the AV1 specification.

The same `StreamSpec` always gives byte-identical output. `stream_path`
caches files under `<checkout>/.streams/`, keyed by the spec and a hash of
the generator and syntax sources.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
from dataclasses import dataclass

import numpy as np

from ..headers import (
    AdaptiveBoolean,
    FilterMode,
    FrameHeader,
    FrameType,
    PixelLayout,
    Profile,
    RestorationType,
    SequenceHeader,
    TxfmMode,
    PRIMARY_REF_NONE,
)
from . import headers as W
from .msac import MsacEncoder, SymbolChooser

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_DIR = os.path.join(_ROOT, ".streams")

_PARTITION_NONE_P = 0.03
_COEF_SKIP_P = 0.05


@dataclass(frozen=True)
class StreamSpec:
    """What to generate. `tiles` is a uniform (cols, rows) grid of powers of
    two; `kf_every` = 0 codes one key frame and then inter frames, n > 0 a
    key frame every n frames."""

    seed: int
    width: int
    height: int
    bpc: int = 8
    frames: int = 8
    tiles: tuple = (1, 1)
    kf_every: int = 0

    def name(self) -> str:
        return (f"{self.width}x{self.height}-{self.bpc}b-{self.frames}f"
                f"-t{self.tiles[0]}x{self.tiles[1]}-k{self.kf_every}"
                f"-s{self.seed}")


def _sources_hash() -> str:
    pkg = os.path.join(_ROOT, "rav1d_jax")
    h = hashlib.sha1()
    paths = []
    for sub in ("gen", "syntax", "entropy", "recon", "tables", "bits"):
        d = os.path.join(pkg, sub)
        paths += [os.path.join(d, n) for n in os.listdir(d)
                  if n.endswith((".py", ".npz"))]
    paths += [os.path.join(pkg, n) for n in ("obu.py", "headers.py", "decoder.py")]
    for p in sorted(paths):
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


def stream_path(spec: StreamSpec) -> str:
    """Path of the generated IVF file for `spec`, generating it on a miss."""
    path = os.path.join(CACHE_DIR, f"{spec.name()}-{_sources_hash()}.ivf")
    if not os.path.exists(path):
        data = generate(spec)
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    return path


def sequence_header(spec: StreamSpec) -> SequenceHeader:
    s = SequenceHeader()
    s.profile = Profile.MAIN
    s.operating_points[0].major_level = 5 if spec.width * spec.height > 2228224 else 4
    s.operating_points[0].initial_display_delay = 10
    s.width_n_bits = max(1, (spec.width - 1).bit_length())
    s.height_n_bits = max(1, (spec.height - 1).bit_length())
    s.max_width = spec.width
    s.max_height = spec.height
    s.filter_intra = s.intra_edge_filter = 1
    s.inter_intra = s.masked_compound = s.warped_motion = s.dual_filter = 1
    s.order_hint = s.jnt_comp = s.ref_frame_mvs = 1
    s.order_hint_n_bits = 7
    s.force_integer_mv = AdaptiveBoolean.ADAPTIVE  # what obu.py derives
    s.cdef = s.restoration = 1
    s.hbd = {8: 0, 10: 1}[spec.bpc]
    s.layout = PixelLayout.I420
    s.ss_hor = s.ss_ver = 1
    return s


def _frame_header(spec, seq, idx, rng) -> FrameHeader:
    """Header of frame `idx`: a key frame, or an inter frame whose seven
    references are the previous frames (slot of frame k is k % 8)."""
    h = FrameHeader()
    key = idx == 0 or (spec.kf_every and idx % spec.kf_every == 0)
    h.frame_type = FrameType.KEY if key else FrameType.INTER
    h.show_frame = 1
    h.showable_frame = 0 if key else 1
    h.frame_offset = idx % (1 << seq.order_hint_n_bits)
    h.size.width = (spec.width, spec.width)
    h.size.height = spec.height
    h.size.render_width, h.size.render_height = spec.width, spec.height
    if key:
        h.error_resilient_mode = 1
        h.primary_ref_frame = PRIMARY_REF_NONE
        h.refresh_frame_flags = 0xFF
        h.force_integer_mv = True
    else:
        h.primary_ref_frame = 0
        h.refresh_frame_flags = 1 << (idx % 8)
        last_key = idx - (idx % spec.kf_every if spec.kf_every else idx)
        h.refidx = [(idx - 1 - i) % 8 if idx - 1 - i >= last_key else last_key % 8
                    for i in range(7)]
        h.hp = True
        h.subpel_filter_mode = FilterMode.SWITCHABLE
        h.switchable_motion_mode = 1
        h.use_ref_frame_mvs = 1
        h.switchable_comp_refs = 1
        h.warp_motion = 1
    h.refresh_context = 1
    t = h.tiling
    t.log2_cols = spec.tiles[0].bit_length() - 1
    t.log2_rows = spec.tiles[1].bit_length() - 1
    if t.log2_cols or t.log2_rows:
        t.update = int(rng.integers(spec.tiles[0] * spec.tiles[1]))
        t.n_bytes = 4
    h.quant.yac = int(rng.integers(60, 200))
    lf = h.loopfilter
    lf.level_y = [int(rng.integers(4, 40)), int(rng.integers(4, 40))]
    lf.level_u, lf.level_v = int(rng.integers(2, 30)), int(rng.integers(2, 30))
    lf.sharpness = int(rng.integers(0, 8))
    lf.mode_ref_delta_enabled = 1
    c = h.cdef
    c.damping = int(rng.integers(3, 7))
    c.n_bits = 2
    c.y_strength = [int(v) for v in rng.integers(1, 64, 8)]
    c.uv_strength = [int(v) for v in rng.integers(1, 64, 8)]
    h.restoration.type = (RestorationType.SWITCHABLE, RestorationType.WIENER,
                          RestorationType.SGRPROJ)
    h.restoration.unit_size = (6, 6)
    h.txfm_mode = TxfmMode.SWITCHABLE
    return h


def _skip_mode_allowed(dec, seq, h) -> bool:
    from ..bits import GetBits
    from ..obu import _parse_skip_mode

    sm = _parse_skip_mode(dec, seq, h.switchable_comp_refs, h.frame_type,
                          h.frame_offset, h.refidx, GetBits(b"\x00"))
    return bool(sm.allowed)


@contextlib.contextmanager
def _choosing(seed_seq, choosers):
    """Run the Python syntax anchor with symbol choosers as tile entropy
    sources and without the dense pass."""
    from ..native import syntax as nsy
    from ..recon import frame as fr
    from ..syntax import decode as sd

    def tile_msac(data, disable_cdf_update, cdf):
        ch = SymbolChooser(np.random.default_rng(seed_seq.spawn(1)[0]),
                           disable_cdf_update,
                           {id(cdf.m.partition): (0, _PARTITION_NONE_P),
                            id(cdf.coef.skip): (1, _COEF_SKIP_P)})
        choosers.append(ch)
        return ch

    saved = (sd.TILE_MSAC, nsy.FORCE_OFF, fr.decode_frame_dense,
             os.environ.get("RAV1D_ENGINE"))
    sd.TILE_MSAC = tile_msac
    nsy.FORCE_OFF = True
    fr.decode_frame_dense = _no_dense
    os.environ["RAV1D_ENGINE"] = "np"
    try:
        yield
    finally:
        sd.TILE_MSAC, nsy.FORCE_OFF, fr.decode_frame_dense, env = saved
        if env is None:
            os.environ.pop("RAV1D_ENGINE", None)
        else:
            os.environ["RAV1D_ENGINE"] = env


def _no_dense(f):
    f._dense_args = None


def generate(spec: StreamSpec) -> bytes:
    """Generate the IVF bytes of `spec` (deterministic in the spec)."""
    from ..decoder import Decoder, EAgain, Settings

    cols, rows = spec.tiles
    for n in (cols, rows):
        if n < 1 or n & (n - 1):
            raise ValueError("tile counts must be powers of two")
    seq = sequence_header(spec)
    seed_seq = np.random.SeedSequence(spec.seed)
    rng = np.random.default_rng(seed_seq.spawn(1)[0])
    dec = Decoder(Settings(n_threads=1, apply_grain=False))
    packets = []
    seq_bytes = W.seq_obu(seq)
    for idx in range(spec.frames):
        h = _frame_header(spec, seq, idx, rng)
        sm_ok = False
        if h.frame_type == FrameType.INTER:
            dec_seq = dec.seq_hdr
            sm_ok = _skip_mode_allowed(dec, dec_seq, h)
            h.skip_mode.enabled = 1 if sm_ok else 0
        head = W.TD_OBU + (seq_bytes if h.frame_type == FrameType.KEY else b"")
        choosers = []
        placeholder = [b"\x00"] * (cols * rows)
        with _choosing(seed_seq, choosers):
            dec.send_data(head + W.frame_obu(seq, h, sm_ok, placeholder))
            with contextlib.suppress(EAgain):
                dec.get_picture()
        if len(choosers) != cols * rows:
            raise RuntimeError("the syntax walk did not open every tile")
        tiles = [MsacEncoder().encode_all(ch.record) for ch in choosers]
        packets.append(head + W.frame_obu(seq, h, sm_ok, tiles))
    return W.ivf(spec.width, spec.height, packets)


def frame_headers(spec: StreamSpec):
    """The (sequence header, frame headers) `generate` writes for `spec`."""
    rng = np.random.default_rng(np.random.SeedSequence(spec.seed).spawn(1)[0])
    seq = sequence_header(spec)
    return seq, [_frame_header(spec, seq, i, rng) for i in range(spec.frames)]
