"""Command-line decoder on a CUDA card (or the CPU): capture files and
live pipes.

    python -m vdlm2dec_tpu_torch.cli 136.725 136.775 --iq cap.cu8 -J
    python -m vdlm2dec_tpu_torch.cli 136.975 --iq air.f32 --format f32real \
        --fs 6000000 -J
    rtl_sdr -f 136900000 -s 2000000 - | \
        python -m vdlm2dec_tpu_torch.cli 136.975 --iq - --fc 136900000 -J

The JAX package's CLI (vdlm2dec_tpu/cli.py), flag for flag and with the
same defaults: freqs in MHz, -v -q -J -R -a -G -E -U -b -i -j -s -l -p
-g -r -k --devices, --iq FILE|-, --format cu8|cs16|cf32|f32real, --fs,
--fc, --block-seconds, --max-rows, --start-time, --stats,
--stats-interval, --checkpoint, --pallas, --channel-filter boxcar|fir,
--sync-impl xla|stream|fused, --compute f32|bf16,
--chan-impl auto|dft|matmul|pfb, --mesh CxT; plus --device (the torch
device of the device stages).  --mesh builds a chan x time mesh from the
visible cards (from the CPU, repeated, under --device cpu) and takes the
host-converted streaming route, as the JAX CLI does.
"""
from __future__ import annotations

import argparse
import os
import select
import signal
import socket
import sys
import threading
import time

from ._tables import PipelineConfig
from .constants import MAX_BURST_SYMBOLS
from .host.checkpoint import load_checkpoint, save_checkpoint
from .host.output import OutputConfig
from .io.sdr import (R820T_GAINS, CaptureReader, choose_fc, choose_fc_airspy,
                     match_device, nearest_gain, validate_freqs)
from .metrics import PipelineMetrics


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vdlm2t-torch",
        description="VDL Mode 2 decoder, PyTorch/CUDA backend "
                    "(vdlm2dec-compatible output)")
    p.add_argument("freqs", nargs="+", type=float, help="frequencies in MHz")
    p.add_argument("--iq", required=True,
                   help="capture file, or - for a live pipe on stdin")
    p.add_argument("--format", default="cu8",
                   choices=["cu8", "cs16", "cf32", "f32real"])
    p.add_argument("--fs", type=int, default=2_000_000)
    p.add_argument("--fc", type=float, default=None)
    p.add_argument("--block-seconds", type=float, default=4.0)
    p.add_argument("--max-rows", type=int, default=8)
    p.add_argument("--mesh", default=None,
                   help="chan x time device mesh, e.g. 2x4: one visible "
                        "card per shard (the CPU for every shard under "
                        "--device cpu); streams through the host-converted "
                        "route")
    p.add_argument("--start-time", type=float, default=None,
                   help="capture start unix time (default: now)")
    p.add_argument("--stats", action="store_true",
                   help="print per-stage metrics JSON to stderr at end")
    p.add_argument("--stats-interval", type=float, default=0.0,
                   help="also print the metrics JSON to stderr every N "
                        "seconds while decoding (long/live jobs)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file: resume from it and update per block")
    p.add_argument("--pallas", action="store_true",
                   help="cu8 through the fused u8 channelizer (a CUDA "
                        "kernel on a card) with the dense matmul "
                        "channelizer")
    p.add_argument("--channel-filter", default="boxcar",
                   choices=["boxcar", "fir"],
                   help="boxcar = reference-parity integrate-and-dump; "
                        "fir = windowed-sinc decimation (dense matmul "
                        "channelizer, non-fused streaming)")
    p.add_argument("--sync-impl", default="stream",
                   choices=["xla", "stream", "fused"],
                   help="sync scan numerics: stream (running sums, libm "
                        "atan2) or fused (two-pass, Cephes atan2), both "
                        "the same CUDA kernel on a card; xla = stream's "
                        "metric with the demod reading the materialized "
                        "four-branch filter output")
    p.add_argument("--compute", default="f32", choices=["f32", "bf16"],
                   help="bf16: channelizer matmuls on bfloat16-rounded "
                        "operands with float32 sums")
    p.add_argument("--chan-impl", default="auto",
                   choices=["auto", "matmul", "dft", "pfb"],
                   help="auto = residue-space dft when the plan is "
                        "eligible (raster offsets, boxcar, no --pallas), "
                        "else dense matmul; pfb = factorized-DFT "
                        "filterbank")
    p.add_argument("--device", default="cuda",
                   help="torch device for the device stages (cuda, cuda:1, "
                        "cpu)")

    p.add_argument("-v", dest="verbose", action="store_true")
    p.add_argument("-q", dest="quiet", action="store_true")
    p.add_argument("-J", dest="jsonout", action="store_true")
    p.add_argument("-R", dest="routeout", action="store_true")
    p.add_argument("-a", dest="regout", action="store_true")
    p.add_argument("-G", dest="grndmess", action="store_true")
    p.add_argument("-E", dest="emptymess", action="store_true")
    p.add_argument("-U", dest="undecmess", action="store_true")
    p.add_argument("-b", dest="labelfilter", default=None)
    # reference default station id = hostname (main.c:120-121)
    p.add_argument("-i", dest="station", default=socket.gethostname()[:48])
    p.add_argument("-p", dest="ppm", type=float, default=0.0,
                   help="frequency correction in ppm (rtl.c:211-216), "
                        "applied as an fc shift")
    p.add_argument("-g", dest="gain", type=int, default=None,
                   help="rtl: preamp gain in tenths of dB, snapped to the "
                        "nearest supported value (rtl.c:162-184); airspy "
                        "(f32real): linearity gain 0-21 (air.c:159)")
    p.add_argument("-r", dest="rtldevice", default=None,
                   help="rtl device number or serial, validated against "
                        "--devices when given (rtl.c:47-121)")
    p.add_argument("-k", dest="airspy_serial", default=None,
                   help="airspy serial number in hex (main.c:156-158)")
    p.add_argument("--devices", default=None,
                   help="comma-separated known device serials for -r "
                        "matching (stands in for the USB enumeration)")
    p.add_argument("-j", dest="netjson", default=None)
    p.add_argument("-s", dest="netsbs", default=None)
    p.add_argument("-l", dest="logfile", default=None)
    return p


def refusal(args) -> str | None:
    """The JAX CLI's own refusals of flag combinations (exit 1)."""
    if args.chan_impl in ("dft", "pfb") and args.pallas:
        return (f"--chan-impl {args.chan_impl} replaces the Pallas ingest "
                "kernel; drop --pallas")
    if args.chan_impl in ("dft", "pfb") and args.channel_filter != "boxcar":
        return (f"--chan-impl {args.chan_impl} requires the boxcar channel "
                "filter")
    return None


def sdr_refusal(args) -> str | None:
    """Validation of the SDR device and gain flags (exit 1), with the
    reference's verbose prints; the USB side needs real hardware."""
    real_input = args.format == "f32real"
    if args.gain is not None:
        if real_input:
            if not 0 <= args.gain <= 21:
                return "airspy linearity gain must be 0-21"
            gain = args.gain                              # air.c:159
        else:
            gain = nearest_gain(args.gain, R820T_GAINS)   # rtl.c:162-184
        if args.verbose:
            print(f"Gain set to {gain / 10:.1f}" if not real_input
                  else f"Linearity gain {gain}", file=sys.stderr)
    if args.rtldevice is not None and args.devices is not None:
        idx = match_device(args.rtldevice, args.devices.split(","))
        if idx < 0:                                       # rtl.c:118-120
            return f"No matching device found for {args.rtldevice}"
        if args.verbose:
            print(f"Using device {idx}", file=sys.stderr)
    if args.airspy_serial is not None:
        try:
            int(args.airspy_serial, 16)                   # strtoull(,,16)
        except ValueError:
            return f"invalid airspy serial {args.airspy_serial}"
    return None


def mesh_from_flag(args):
    """The mesh --mesh CxT asks for, or None.  Raises ValueError when the
    flag does not parse or there are fewer devices than shards."""
    if not args.mesh:
        return None
    import torch

    from .parallel.sharding import make_mesh

    try:
        c, t = (int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes CxT, e.g. 2x4; got {args.mesh!r}")
    on_cpu = torch.device(args.device).type == "cpu"
    try:
        return make_mesh(c, t, devices=["cpu"] * (c * t) if on_cpu else None)
    except ValueError as e:
        raise ValueError(f"--mesh {args.mesh}: {e} (visible CUDA cards)")


def pipeline_config(args, freqs: list[int], mesh=None) -> PipelineConfig:
    """The PipelineConfig the command line asks for.  Raises ValueError
    when chooseFc finds no usable center."""
    real_input = args.format == "f32real"
    if args.fc is not None:
        fc = args.fc
    elif real_input:
        fc = choose_fc_airspy(freqs, args.fs)
    else:
        fc = choose_fc(freqs, args.fs)
    if args.ppm:
        # a tuner ppm error shifts every RF frequency; the dominant effect
        # is a shift of the effective center frequency
        fc = fc * (1.0 + args.ppm / 1e6)
    return PipelineConfig(
        freqs_hz=[float(f) for f in freqs],
        fs=args.fs,
        fc_hz=float(fc),
        real_input=real_input,
        max_symbols=min(MAX_BURST_SYMBOLS, args.max_rows * 680 + 16),
        mesh=mesh,
        use_pallas=args.pallas,
        filter_mode=args.channel_filter,
        chan_impl=args.chan_impl,
        compute=args.compute,
        sync_impl=args.sync_impl,
    )


def output_config(args, logfile=None) -> OutputConfig:
    """The OutputConfig the command line asks for: -R implies -J, -a
    turns JSON off, and either silences the text (main.c:169-176,
    200-201)."""
    verbose = 0 if args.quiet else (2 if args.verbose else 1)
    jsonout = (args.jsonout or args.routeout) and not args.regout
    if jsonout or args.regout:
        verbose = 0
    return OutputConfig(
        verbose=verbose, jsonout=jsonout, routeout=args.routeout,
        regout=args.regout, grndmess=args.grndmess,
        emptymess=args.emptymess, undecmess=args.undecmess,
        station_id=args.station, net_json_addr=args.netjson,
        net_sbs_addr=args.netsbs, logfile=logfile)


def _stop_on_signals() -> None:
    """SIGTERM and SIGQUIT drain and exit like SIGINT (sighandler ->
    stopVdlm2, main.c:106-110,215-220)."""
    def stop(signum, frame):
        raise KeyboardInterrupt

    if threading.current_thread() is not threading.main_thread():
        return
    for sig in (signal.SIGTERM, getattr(signal, "SIGQUIT", None)):
        if sig is not None:
            try:
                signal.signal(sig, stop)
            except (ValueError, OSError):
                pass


class _LiveStdin:
    """stdin of the live route, read so that a signal always stops it.

    The OS may hand a process-directed SIGTERM to any thread (the fetch
    thread, torch's pools); the main thread then runs the handler only
    when it next executes bytecode, and never while it sits in read(2)
    on a pipe whose writer has gone quiet.  So read() waits for data in
    slices of POLL_S and comes back to the interpreter between them."""
    POLL_S = 0.2

    def __init__(self, fd: int):
        self._fd = fd

    def read(self, n: int) -> bytes:
        """n bytes, or fewer at end of stream (b"" when nothing is left)."""
        parts, got = [], 0
        while got < n:
            if not select.select([self._fd], [], [], self.POLL_S)[0]:
                continue
            chunk = os.read(self._fd, n - got)
            if not chunk:
                break
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _stop_on_signals()
    freqs = validate_freqs([int(f * 1e6) for f in args.freqs])
    if not freqs:
        print("Need at least one valid frequency (118-138 MHz)",
              file=sys.stderr)
        return 1
    msg = refusal(args)
    if msg:
        print(msg, file=sys.stderr)
        return 1
    try:
        cfg = pipeline_config(args, freqs, mesh_from_flag(args))
    except ValueError as e:       # no usable center, or too few devices
        print(str(e), file=sys.stderr)
        return 1
    msg = sdr_refusal(args)
    if msg:
        print(msg, file=sys.stderr)
        return 1

    from .host.decoder import FrameDecoder
    from .pipeline import Pipeline

    logfd = open(args.logfile, "a") if args.logfile else None
    try:
        pipe = Pipeline(cfg, device=args.device)
        out_cfg = output_config(args, logfd)
        dec = FrameDecoder(out_cfg, label_filter=args.labelfilter,
                           time_base=args.start_time)
        return _decode(args, pipe, dec, out_cfg.verbose)
    finally:
        if logfd:
            logfd.close()


def _decode(args, pipe, dec, verbose: int) -> int:
    """Stream the capture (or the pipe) through pipe into dec."""
    metrics = PipelineMetrics()
    pipe.metrics = metrics
    last_stats = time.monotonic()

    def periodic_stats():
        nonlocal last_stats
        if (args.stats_interval
                and time.monotonic() - last_stats >= args.stats_interval):
            last_stats = time.monotonic()
            print(metrics.report(), file=sys.stderr)

    checkpoint = None
    if args.iq == "-":
        # live pipe: rtl_sdr/airspy_rx | vdlm2t-torch ... --iq -
        stream = pipe.stream_live(_LiveStdin(sys.stdin.fileno()),
                                  fmt=args.format,
                                  block_seconds=args.block_seconds)
    else:
        try:
            reader = CaptureReader(args.iq, args.format)
        except (OSError, ValueError) as e:
            print(f"unable to open {args.iq}: {e}", file=sys.stderr)
            return 1
        metrics.samples_in = len(reader)
        stream, checkpoint = _file_stream(args, pipe, dec, reader)

    n_frames = 0
    try:
        for bursts in stream:
            metrics.observe_bursts(bursts)
            for b in bursts:
                dec.process_burst(b)
                n_frames += len(b.frames)
            if checkpoint is not None:
                checkpoint()
            periodic_stats()
    except KeyboardInterrupt:
        # drain-and-exit (main.c:106-110): what was decoded is flushed
        pass
    metrics.frames_emitted = dec.stats.acars + dec.stats.xid
    if args.stats:
        print(metrics.report(), file=sys.stderr)
    if verbose:
        print(f"\n# {n_frames} frames decoded", file=sys.stderr)
    return 0


def _file_stream(args, pipe, dec, reader):
    """(block stream, per-block checkpoint callback or None) of a capture
    file.  Blocks are addressed by absolute position, so resuming at the
    checkpoint's block-aligned cursor with its prev_end (the cross-block
    burst-span suppression) prints exactly the uninterrupted run's
    remaining lines."""
    cursor = 0
    prev_end: dict[int, int] = {}
    if args.checkpoint:
        if os.path.exists(args.checkpoint):
            cursor, extra = load_checkpoint(args.checkpoint, dec.flights)
            prev_end = {int(k): int(v)
                        for k, v in extra.get("prev_end", {}).items()}
    total = len(reader)
    core_raw = pipe.core_raw_samples(args.block_seconds)
    start_block = min(cursor, total) // core_raw
    if pipe.fused_route(args.format) and pipe.cfg.mesh is None:
        # native-format raw blocks through the fused device program
        stream = pipe.stream_wideband_u8(
            reader.raw, block_seconds=args.block_seconds,
            start_block=start_block, prev_end=prev_end, fmt=args.format)
    else:
        # host conversion, then the channelizer's sample entry
        stream = pipe.stream_wideband(
            reader, block_seconds=args.block_seconds,
            start_block=start_block, prev_end=prev_end)
    if not args.checkpoint:
        return stream, None
    done = [start_block]

    def checkpoint():
        done[0] += 1
        save_checkpoint(args.checkpoint, min(done[0] * core_raw, total),
                        dec.flights, extra={"prev_end": prev_end})

    return stream, checkpoint


if __name__ == "__main__":
    sys.exit(main())
