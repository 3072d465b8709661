"""dav1d-compatible CLI decoder.

Behavior parity with the reference tool (tools/dav1d.rs:275-657 main loop,
tools/dav1d_cli_parse.rs options). Usage:

    python -m rav1d_jax.cli -i in.ivf --verify <md5>
    python -m rav1d_jax.cli -i in.ivf -o out.y4m
    python -m rav1d_jax.cli -i in.obu --muxer yuv -o out.yuv --limit 10

Muxer is picked from the output extension when not forced
(tools/output/output.rs), demuxer from content probing
(tools/input/input.rs). `--verify` implies the md5 muxer and exits
non-zero on mismatch, exactly like `dav1d --verify`.
"""

from __future__ import annotations

import argparse
import sys
import time

from .decoder import Decoder, EAgain, Settings
from .io import probe_demuxer
from .io.ivf import IvfDemuxer
from .io.muxers import Md5Muxer, NullMuxer, Y4mMuxer, YuvMuxer

VERSION = "0.1.0 (rav1d_jax)"

_MUXERS = {
    "md5": Md5Muxer,
    "yuv": YuvMuxer,
    "yuv4mpeg2": Y4mMuxer,
    "y4m": Y4mMuxer,
    "null": NullMuxer,
}

_EXT_MUXER = {"y4m": "yuv4mpeg2", "yuv": "yuv", "md5": "md5", "null": "null"}

_INLOOP = {
    "none": 0,
    "deblock": 1,
    "nodeblock": 6,
    "cdef": 2,
    "nocdef": 5,
    "restoration": 4,
    "norestoration": 3,
    "all": 7,
}

_FRAMETYPE = {"all": 0, "reference": 1, "intra": 2, "key": 3}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dav1d", add_help=True)
    p.add_argument("--input", "-i", required=False)
    p.add_argument("--output", "-o")
    p.add_argument("--demuxer", choices=["ivf", "annexb", "section5"])
    p.add_argument("--muxer", choices=sorted(_MUXERS))
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument("--limit", "-l", type=int, default=0)
    p.add_argument("--skip", "-s", type=int, default=0)
    p.add_argument("--version", "-v", action="store_true")
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--framedelay", type=int, default=0)
    p.add_argument("--filmgrain", type=int, default=None)
    p.add_argument("--oppoint", type=int, default=0)
    p.add_argument("--alllayers", type=int, default=1)
    p.add_argument("--sizelimit", type=int, default=0)
    p.add_argument("--strict", type=int, default=1)
    p.add_argument("--verify")
    p.add_argument("--cpumask", default=None)  # accepted for parity; no-op here
    p.add_argument("--negstride", action="store_true")  # developer option; no-op
    p.add_argument("--outputinvisible", type=int, default=0)
    p.add_argument("--inloopfilters", choices=sorted(_INLOOP), default="all")
    p.add_argument("--decodeframetype", choices=sorted(_FRAMETYPE), default="all")
    p.add_argument("--realtime", nargs="?", const="input", default=None)
    p.add_argument("--frametimes")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.version:
        print(VERSION)
        return 0
    if not args.input:
        print("error: input file required", file=sys.stderr)
        return 1

    muxer_name = args.muxer
    if args.verify:
        muxer_name = "md5"
    if muxer_name is None and args.output:
        ext = args.output.rsplit(".", 1)[-1].lower()
        muxer_name = _EXT_MUXER.get(ext, "yuv")
    if muxer_name is None:
        muxer_name = "null"

    # film grain defaults off for md5 output, matching dav1d's CLI default
    apply_grain = args.filmgrain if args.filmgrain is not None else (muxer_name != "md5")

    settings = Settings(
        n_threads=args.threads,
        max_frame_delay=args.framedelay,
        apply_grain=bool(apply_grain),
        operating_point=args.oppoint,
        all_layers=bool(args.alllayers),
        frame_size_limit=args.sizelimit,
        strict_std_compliance=bool(args.strict),
        output_invisible_frames=bool(args.outputinvisible),
        inloop_filters=_INLOOP[args.inloopfilters],
        decode_frame_type=_FRAMETYPE[args.decodeframetype],
    )

    if args.demuxer == "ivf":
        demux = IvfDemuxer(args.input)
    elif args.demuxer in ("annexb", "section5"):
        from .io.ivf import AnnexBDemuxer, Section5Demuxer

        demux = (AnnexBDemuxer if args.demuxer == "annexb" else Section5Demuxer)(args.input)
    else:
        demux = probe_demuxer(args.input)

    mux = _MUXERS[muxer_name](args.output or "-")
    dec = Decoder(settings)

    frametimes = open(args.frametimes, "w") if args.frametimes else None
    fps_num, fps_den = getattr(demux, "fps", (25, 1)) or (25, 1)
    frame_period = fps_den / fps_num if (args.realtime and fps_num) else 0.0
    if args.realtime not in (None, "input"):
        try:
            frame_period = 1.0 / float(args.realtime)
        except ValueError:
            pass

    n_out = 0
    n_seen = 0
    t_start = time.perf_counter()
    t_last = t_start

    def emit(pic):
        nonlocal n_out, n_seen, t_last
        n_seen += 1
        if n_seen <= args.skip:
            return False
        if frametimes is not None:
            now = time.perf_counter()
            frametimes.write(f"{(now - t_last) * 1e9:.0f}\n")
            t_last = now
        if frame_period:
            target = t_start + n_out * frame_period
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        mux.write_picture(pic)
        n_out += 1
        if not args.quiet and n_out % 16 == 0:
            el = time.perf_counter() - t_start
            print(f"\rDecoded {n_out} frames ({n_out / el:.2f} fps)", end="", file=sys.stderr)
        return args.limit and n_out >= args.limit

    done = False
    for pkt in demux:
        try:
            dec.send_data(pkt.data, pkt.timestamp)
        except EAgain:
            pass
        # one get per send (dav1d.c main-loop shape): under the engine's
        # delayed-output ring this keeps N frames in flight so device
        # fetches batch; a second get here would trigger the drain
        # handshake and collapse the pipeline to depth 1
        if not done:
            try:
                done = emit(dec.get_picture())
            except EAgain:
                pass
        if done:
            break
    while not done:  # drain
        try:
            done = emit(dec.get_picture())
        except EAgain:
            break

    mux.write_trailer() if not args.verify else None
    if frametimes:
        frametimes.close()
    if not args.quiet:
        el = time.perf_counter() - t_start
        print(f"\rDecoded {n_out}/{n_seen} frames ({n_out / max(el, 1e-9):.2f} fps)", file=sys.stderr)

    if args.verify:
        if not mux.verify(args.verify):
            print(f"MD5 mismatch: got {mux.digest()}, expected {args.verify}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
