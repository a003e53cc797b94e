"""Command-line decoder for capture files on a CUDA card (or the CPU).

    python -m vdlm2dec_tpu_torch.cli 136.725 136.775 --iq cap.cu8 -J
    python -m vdlm2dec_tpu_torch.cli 136.975 --iq air.f32 --format f32real \
        --fs 6000000 -J

The file path of the JAX package's CLI (vdlm2dec_tpu/cli.py), with the
same flag names and defaults for what this package runs: freqs in MHz,
--iq, --format cu8|cs16|cf32|f32real, --fs, --fc, --block-seconds,
--max-rows, -J, -G, -E, -U, -i, -v, -q, --start-time, --stats, --pallas,
--chan-impl auto|dft|matmul|pfb, --sync-impl stream|fused and --device.
Flags whose paths are not ported are accepted by the parser and refused
with an error naming them.
"""
from __future__ import annotations

import argparse
import socket
import sys

from vdlm2dec_tpu.constants import MAX_BURST_SYMBOLS
from vdlm2dec_tpu.host.output import OutputConfig
from vdlm2dec_tpu.io.sdr import (CaptureReader, choose_fc, choose_fc_airspy,
                                 validate_freqs)
from vdlm2dec_tpu.metrics import PipelineMetrics

from ._tables import PipelineConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vdlm2t-torch",
        description="VDL Mode 2 decoder, PyTorch/CUDA backend "
                    "(vdlm2dec-compatible output)")
    p.add_argument("freqs", nargs="+", type=float, help="frequencies in MHz")
    p.add_argument("--iq", required=True, help="capture file")
    p.add_argument("--format", default="cu8",
                   choices=["cu8", "cs16", "cf32", "f32real"])
    p.add_argument("--fs", type=int, default=2_000_000)
    p.add_argument("--fc", type=float, default=None)
    p.add_argument("--block-seconds", type=float, default=4.0)
    p.add_argument("--max-rows", type=int, default=8)
    p.add_argument("--start-time", type=float, default=None,
                   help="capture start unix time (default: now)")
    p.add_argument("--stats", action="store_true",
                   help="print per-stage metrics JSON to stderr at end")
    p.add_argument("--sync-impl", default="stream",
                   choices=["xla", "stream", "fused"],
                   help="sync scan numerics: stream (running sums, libm "
                        "atan2) or fused (two-pass, Cephes atan2); both run "
                        "the same CUDA kernel on a card")
    p.add_argument("--device", default="cuda",
                   help="torch device for the device stages (cuda, cuda:1, "
                        "cpu)")
    p.add_argument("--pallas", action="store_true",
                   help="cu8 through the fused u8 channelizer (a CUDA "
                        "kernel on a card) with the dense matmul "
                        "channelizer")
    p.add_argument("--chan-impl", default="auto",
                   choices=["auto", "matmul", "dft", "pfb"],
                   help="auto = residue-space dft when the plan is "
                        "eligible (raster offsets, no --pallas), else dense "
                        "matmul; pfb = factorized-DFT filterbank")
    # flags of paths this package does not run yet
    p.add_argument("--mesh", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--channel-filter", default="boxcar",
                   choices=["boxcar", "fir"])
    p.add_argument("--compute", default="f32", choices=["f32", "bf16"])

    p.add_argument("-v", dest="verbose", action="store_true")
    p.add_argument("-q", dest="quiet", action="store_true")
    p.add_argument("-J", dest="jsonout", action="store_true")
    p.add_argument("-G", dest="grndmess", action="store_true")
    p.add_argument("-E", dest="emptymess", action="store_true")
    p.add_argument("-U", dest="undecmess", action="store_true")
    p.add_argument("-i", dest="station", default=socket.gethostname()[:48])
    return p


def unported(args) -> str | None:
    """The first flag of the command line whose path is not ported."""
    checks = [
        (args.iq == "-", "--iq - (live input)"),
        (args.mesh is not None, "--mesh"),
        (args.checkpoint is not None, "--checkpoint"),
        # the JAX CLI takes the non-fused stream_wideband route here
        (args.pallas and args.format != "cu8",
         f"--pallas with --format {args.format}"),
        (args.channel_filter != "boxcar",
         f"--channel-filter {args.channel_filter}"),
        (args.compute != "f32", f"--compute {args.compute}"),
        (args.sync_impl == "xla", "--sync-impl xla"),
    ]
    for bad, flag in checks:
        if bad:
            return flag
    return None


def refusal(args) -> str | None:
    """The JAX CLI's own refusals of flag combinations (exit 1)."""
    if args.chan_impl in ("dft", "pfb") and args.pallas:
        return (f"--chan-impl {args.chan_impl} replaces the Pallas ingest "
                "kernel; drop --pallas")
    if args.chan_impl in ("dft", "pfb") and args.channel_filter != "boxcar":
        return (f"--chan-impl {args.chan_impl} requires the boxcar channel "
                "filter")
    return None


def pipeline_config(args, freqs: list[int]) -> PipelineConfig:
    """The PipelineConfig the command line asks for."""
    real_input = args.format == "f32real"
    if args.fc is not None:
        fc = args.fc
    elif real_input:
        fc = choose_fc_airspy(freqs, args.fs)
    else:
        fc = choose_fc(freqs, args.fs)
    return PipelineConfig(
        freqs_hz=[float(f) for f in freqs],
        fs=args.fs,
        fc_hz=float(fc),
        real_input=real_input,
        max_symbols=min(MAX_BURST_SYMBOLS, args.max_rows * 680 + 16),
        use_pallas=args.pallas,
        chan_impl=args.chan_impl,
        sync_impl=args.sync_impl,
    )


def output_config(args, verbose: int) -> OutputConfig:
    return OutputConfig(verbose=verbose, jsonout=args.jsonout,
                        grndmess=args.grndmess, emptymess=args.emptymess,
                        undecmess=args.undecmess, station_id=args.station)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    verbose = 0 if args.quiet else (2 if args.verbose else 1)
    if args.jsonout:
        verbose = 0               # main.c:200-201
    freqs = validate_freqs([int(f * 1e6) for f in args.freqs])
    if not freqs:
        print("Need at least one valid frequency (118-138 MHz)",
              file=sys.stderr)
        return 1
    msg = refusal(args)
    if msg:
        print(msg, file=sys.stderr)
        return 1
    flag = unported(args)
    if flag:
        parser.error(f"{flag} is not supported by the PyTorch backend yet; "
                     "use vdlm2t (python -m vdlm2dec_tpu.cli)")
    try:
        cfg = pipeline_config(args, freqs)
    except ValueError as e:       # chooseFc found no usable center
        print(str(e), file=sys.stderr)
        return 1

    from .host_decoder import FrameDecoder
    from .pipeline import Pipeline

    try:
        reader = CaptureReader(args.iq, args.format)
    except (OSError, ValueError) as e:
        print(f"unable to open {args.iq}: {e}", file=sys.stderr)
        return 1
    pipe = Pipeline(cfg, device=args.device)
    dec = FrameDecoder(output_config(args, verbose), time_base=args.start_time)
    metrics = PipelineMetrics()
    metrics.samples_in = len(reader)
    pipe.metrics = metrics
    n_frames = 0
    try:
        for bursts in pipe.stream_wideband_u8(
                reader.raw, block_seconds=args.block_seconds,
                fmt=args.format):
            metrics.observe_bursts(bursts)
            for b in bursts:
                dec.process_burst(b)
                n_frames += len(b.frames)
    except KeyboardInterrupt:
        pass
    metrics.frames_emitted = dec.stats.acars + dec.stats.xid
    if args.stats:
        print(metrics.report(), file=sys.stderr)
    if verbose:
        print(f"\n# {n_frames} frames decoded", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
