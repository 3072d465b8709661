"""Bit writer and AV1 header/OBU/IVF writers: the inverse of `obu.py`.

Covers the fixed option set the stream generator uses; anything outside it
raises `ValueError` rather than writing a header `obu.py` would read back
differently:

- one operating point (idc 0), no timing / decoder-model / display info,
  no frame ids, Main profile (8-bit or 10-bit 4:2:0, no colour description);
- screen-content tools off (so no palette, intrabc or integer-MV frames),
  superres off, film grain off;
- every frame coded at the sequence's maximum size (no frame-size override,
  no render size), so there are no scaled references;
- uniform tiling only (any power-of-two grid the frame size allows);
- no segmentation, no delta-q / delta-lf, no quantizer matrices, identity
  global motion.
"""

from __future__ import annotations

import struct

from ..headers import (
    AdaptiveBoolean,
    FrameType,
    ObuType,
    PixelLayout,
    Profile,
    RestorationType,
    TxfmMode,
    FilterMode,
    WarpedMotionType,
    PRIMARY_REF_NONE,
)


class PutBits:
    """MSB-first bit writer (the inverse of `bits.GetBits`)."""

    __slots__ = ("_acc", "_n")

    def __init__(self):
        self._acc = 0
        self._n = 0

    def put_bits(self, v: int, n: int):
        if n == 0:
            return
        if not 0 <= v < (1 << n):
            raise ValueError(f"value {v} does not fit in {n} bits")
        self._acc = (self._acc << n) | v
        self._n += n

    def put_bit(self, v: int):
        self.put_bits(1 if v else 0, 1)

    def put_sbits(self, v: int, n: int):
        """n-bit two's complement (read back by `GetBits.get_sbits`)."""
        if not -(1 << (n - 1)) <= v < (1 << (n - 1)):
            raise ValueError(f"value {v} does not fit in {n} signed bits")
        self.put_bits(v & ((1 << n) - 1), n)

    def trailing_bits(self):
        """trailing_one_bit then zero bits up to the byte boundary."""
        self.put_bit(1)
        self.byte_align()

    def byte_align(self):
        pad = (-self._n) & 7
        self.put_bits(0, pad)

    def bytes(self) -> bytes:
        assert self._n & 7 == 0, "unaligned bit stream"
        return self._acc.to_bytes(self._n >> 3, "big") if self._n else b""


def leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def obu(obu_type: ObuType, payload: bytes) -> bytes:
    """One OBU with a size field and no extension header."""
    return bytes([int(obu_type) << 3 | 0x02]) + leb128(len(payload)) + payload


def _check(cond, what):
    if not cond:
        raise ValueError(f"header writer does not support {what}")


def write_seq_hdr(pb: PutBits, h) -> None:
    """sequence_header_obu() for the supported subset (parse: obu.parse_seq_hdr)."""
    _check(h.profile == Profile.MAIN, "profiles other than Main")
    _check(not h.still_picture and not h.reduced_still_picture_header,
           "still pictures")
    _check(not h.timing_info_present and not h.display_model_info_present,
           "timing or display model info")
    _check(h.num_operating_points == 1 and h.operating_points[0].idc == 0,
           "several operating points")
    _check(not h.frame_id_numbers_present, "frame id numbers")
    _check(h.screen_content_tools == AdaptiveBoolean.OFF, "screen content tools")
    _check(not h.super_res, "superres")
    _check(not h.monochrome and not h.color_description_present,
           "monochrome or colour description")
    _check(h.layout == PixelLayout.I420 and h.hbd in (0, 1), "this pixel format")
    _check(not h.film_grain_present, "film grain")
    pb.put_bits(int(h.profile), 3)
    pb.put_bit(0)  # still_picture
    pb.put_bit(0)  # reduced_still_picture_header
    pb.put_bit(0)  # timing_info_present
    pb.put_bit(0)  # initial_display_delay_present
    pb.put_bits(0, 5)  # operating_points_cnt_minus_1
    op = h.operating_points[0]
    pb.put_bits(0, 12)  # idc
    pb.put_bits(op.major_level - 2, 3)
    pb.put_bits(op.minor_level, 2)
    if op.major_level > 3:
        pb.put_bit(op.tier)
    pb.put_bits(h.width_n_bits - 1, 4)
    pb.put_bits(h.height_n_bits - 1, 4)
    pb.put_bits(h.max_width - 1, h.width_n_bits)
    pb.put_bits(h.max_height - 1, h.height_n_bits)
    pb.put_bit(0)  # frame_id_numbers_present
    pb.put_bit(h.sb128)
    pb.put_bit(h.filter_intra)
    pb.put_bit(h.intra_edge_filter)
    pb.put_bit(h.inter_intra)
    pb.put_bit(h.masked_compound)
    pb.put_bit(h.warped_motion)
    pb.put_bit(h.dual_filter)
    pb.put_bit(h.order_hint)
    if h.order_hint:
        pb.put_bit(h.jnt_comp)
        pb.put_bit(h.ref_frame_mvs)
    pb.put_bit(0)  # seq_choose_screen_content_tools
    pb.put_bit(0)  # seq_screen_content_tools = OFF
    if h.order_hint:
        pb.put_bits(h.order_hint_n_bits - 1, 3)
    pb.put_bit(0)  # enable_superres
    pb.put_bit(h.cdef)
    pb.put_bit(h.restoration)
    pb.put_bit(h.hbd)
    pb.put_bit(0)  # mono_chrome
    pb.put_bit(0)  # color_description_present
    pb.put_bit(h.color_range)
    pb.put_bits(int(h.chr), 2)
    pb.put_bit(h.separate_uv_delta_q)
    pb.put_bit(0)  # film_grain_params_present
    pb.trailing_bits()


def write_frame_hdr(pb: PutBits, seq, h, skip_mode_allowed: bool) -> None:
    """uncompressed_header() for the supported subset (parse:
    obu.parse_frame_hdr). `skip_mode_allowed` is the decoder-side derivation
    from the reference order hints (obu._parse_skip_mode)."""
    _check(h.frame_type in (FrameType.KEY, FrameType.INTER), "this frame type")
    _check(h.show_frame, "hidden frames")
    _check(not h.frame_size_override, "frame size override")
    _check(not h.segmentation.enabled, "segmentation")
    _check(not h.delta.q.present, "delta q")
    _check(not h.quant.qm, "quantizer matrices")
    _check(all(g.type == WarpedMotionType.IDENTITY for g in h.gmv),
           "global motion")
    key = h.frame_type == FrameType.KEY
    pb.put_bit(0)  # show_existing_frame
    pb.put_bits(int(h.frame_type), 2)
    pb.put_bit(1)  # show_frame
    if not key:
        pb.put_bit(h.error_resilient_mode)
    else:
        _check(h.error_resilient_mode, "shown key frames without error resilience")
    pb.put_bit(h.disable_cdf_update)
    pb.put_bit(0)  # frame_size_override_flag
    pb.put_bits(h.frame_offset, seq.order_hint_n_bits)
    if not h.error_resilient_mode and not key:
        pb.put_bits(h.primary_ref_frame, 3)
    else:
        _check(h.primary_ref_frame == PRIMARY_REF_NONE, "primary ref on this frame")
    if key:
        _check(h.refresh_frame_flags == 0xFF, "partial refresh on a key frame")
        pb.put_bit(0)  # render_and_frame_size_different
    else:
        pb.put_bits(h.refresh_frame_flags, 8)
        _check(not h.error_resilient_mode, "error resilient inter frames")
        pb.put_bit(h.frame_ref_short_signaling)
        _check(not h.frame_ref_short_signaling, "short ref signaling")
        for i in range(7):
            pb.put_bits(h.refidx[i], 3)
        pb.put_bit(0)  # render_and_frame_size_different
        pb.put_bit(h.hp)  # allow_high_precision_mv (force_integer_mv is 0)
        if h.subpel_filter_mode == FilterMode.SWITCHABLE:
            pb.put_bit(1)
        else:
            pb.put_bit(0)
            pb.put_bits(int(h.subpel_filter_mode), 2)
        pb.put_bit(h.switchable_motion_mode)
        if seq.ref_frame_mvs and seq.order_hint:
            pb.put_bit(h.use_ref_frame_mvs)
    if not h.disable_cdf_update:
        pb.put_bit(0 if h.refresh_context else 1)
    _write_tiling(pb, seq, h)
    q = h.quant
    pb.put_bits(q.yac, 8)
    _write_delta(pb, q.ydc_delta)
    if seq.separate_uv_delta_q:
        pb.put_bit(int(q.udc_delta != q.vdc_delta or q.uac_delta != q.vac_delta))
    _write_delta(pb, q.udc_delta)
    _write_delta(pb, q.uac_delta)
    if seq.separate_uv_delta_q and (q.udc_delta != q.vdc_delta
                                    or q.uac_delta != q.vac_delta):
        _write_delta(pb, q.vdc_delta)
        _write_delta(pb, q.vac_delta)
    pb.put_bit(0)  # using_qmatrix
    pb.put_bit(0)  # segmentation_enabled
    if q.yac:
        pb.put_bit(0)  # delta_q_present
    _check(q.yac, "lossless frames")
    lf = h.loopfilter
    pb.put_bits(lf.level_y[0], 6)
    pb.put_bits(lf.level_y[1], 6)
    if lf.level_y[0] or lf.level_y[1]:
        pb.put_bits(lf.level_u, 6)
        pb.put_bits(lf.level_v, 6)
    pb.put_bits(lf.sharpness, 3)
    pb.put_bit(lf.mode_ref_delta_enabled)
    if lf.mode_ref_delta_enabled:
        pb.put_bit(0)  # loop_filter_delta_update: inherited / default deltas
    if seq.cdef:
        c = h.cdef
        pb.put_bits(c.damping - 3, 2)
        pb.put_bits(c.n_bits, 2)
        for i in range(1 << c.n_bits):
            pb.put_bits(c.y_strength[i], 6)
            pb.put_bits(c.uv_strength[i], 6)
    if seq.restoration:
        r = h.restoration
        for t in r.type:
            pb.put_bits(int(t), 2)
        if r.type != (RestorationType.NONE,) * 3:
            us0, us1 = r.unit_size
            base = 6 + seq.sb128
            _check(us0 - base in (0, 1) or (not seq.sb128 and us0 == 8),
                   "this restoration unit size")
            pb.put_bit(us0 > base)
            if us0 > base and not seq.sb128:
                pb.put_bit(us0 > base + 1)
            if r.type[1] != RestorationType.NONE or r.type[2] != RestorationType.NONE:
                _check(us1 in (us0, us0 - 1), "this chroma unit size")
                pb.put_bit(us0 - us1)
            else:
                _check(us1 == us0, "a chroma unit size without chroma LR")
    pb.put_bit(h.txfm_mode == TxfmMode.SWITCHABLE)
    if not key:
        pb.put_bit(h.switchable_comp_refs)
        if skip_mode_allowed:
            pb.put_bit(h.skip_mode.enabled)
        else:
            _check(not h.skip_mode.enabled, "skip mode where it is not allowed")
        if seq.warped_motion and not h.error_resilient_mode:
            pb.put_bit(h.warp_motion)
    pb.put_bit(h.reduced_txtp_set)
    if not key:
        for _ in range(7):
            pb.put_bit(0)  # is_global: identity


def _write_delta(pb, v):
    pb.put_bit(1 if v else 0)
    if v:
        pb.put_sbits(v, 7)


def _write_tiling(pb, seq, h):
    from ..obu import _tile_log2

    t = h.tiling
    _check(t.uniform, "non-uniform tiling")
    sbsz_log2 = 6 + seq.sb128
    sbw = (h.size.width[0] + (1 << sbsz_log2) - 1) >> sbsz_log2
    sbh = (h.size.height + (1 << sbsz_log2) - 1) >> sbsz_log2
    min_log2_cols = _tile_log2(4096 >> sbsz_log2, sbw)
    max_log2_cols = _tile_log2(1, min(sbw, 64))
    max_log2_rows = _tile_log2(1, min(sbh, 64))
    min_log2_tiles = max(
        _tile_log2((4096 * 2304) >> (2 * sbsz_log2), sbw * sbh), min_log2_cols
    )
    _check(min_log2_cols <= t.log2_cols <= max_log2_cols, "this tile column count")
    pb.put_bit(1)  # uniform_tile_spacing_flag
    for _ in range(min_log2_cols, t.log2_cols):
        pb.put_bit(1)
    if t.log2_cols < max_log2_cols:
        pb.put_bit(0)
    min_log2_rows = max(min_log2_tiles - t.log2_cols, 0)
    _check(min_log2_rows <= t.log2_rows <= max_log2_rows, "this tile row count")
    for _ in range(min_log2_rows, t.log2_rows):
        pb.put_bit(1)
    if t.log2_rows < max_log2_rows:
        pb.put_bit(0)
    if t.log2_cols or t.log2_rows:
        pb.put_bits(t.update, t.log2_cols + t.log2_rows)
        pb.put_bits(t.n_bytes - 1, 2)


def frame_obu(seq, h, skip_mode_allowed, tiles: list[bytes]) -> bytes:
    """OBU_FRAME: header, byte alignment, one tile group holding every tile
    (each but the last prefixed by its `n_bytes` little-endian size - 1)."""
    pb = PutBits()
    write_frame_hdr(pb, seq, h, skip_mode_allowed)
    pb.byte_align()
    if len(tiles) > 1:
        pb.put_bit(0)  # tile_start_and_end_present_flag
        pb.byte_align()
    body = bytearray(pb.bytes())
    n = h.tiling.n_bytes
    for i, data in enumerate(tiles):
        if i < len(tiles) - 1:
            body += (len(data) - 1).to_bytes(n, "little")
        body += data
    return obu(ObuType.FRAME, bytes(body))


def seq_obu(seq) -> bytes:
    pb = PutBits()
    write_seq_hdr(pb, seq)
    return obu(ObuType.SEQ_HDR, pb.bytes())


TD_OBU = obu(ObuType.TD, b"")


def ivf(width: int, height: int, packets: list[bytes]) -> bytes:
    """IVF container at 30 frames/s (read back by io.ivf.IvfDemuxer)."""
    out = bytearray(b"DKIF")
    out += struct.pack("<HH4sHHIIII", 0, 32, b"AV01", width, height, 30, 1,
                       len(packets), 0)
    for ts, p in enumerate(packets):
        out += struct.pack("<IQ", len(p), ts) + p
    return bytes(out)
