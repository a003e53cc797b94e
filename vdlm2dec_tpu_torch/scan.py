"""Frequency scan: find the active VDL-M2 channels of a wideband capture.

    python -m vdlm2dec_tpu_torch.scan --iq cap.cu8 --fs 2000000 \
        --fc 136900000 [--start 136.0] [--stop 137.0] [--format cu8]

The counterpart of the JAX package's tools/scan.py: every 25 kHz channel
of the captured span (two channel steps clear of the band edges and of
DC) streams through Pipeline.stream_wideband at once, and the frequencies
with frames print with their frame counts, most first.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ._tables import PipelineConfig
from .constants import STEPRATE
from .io.sdr import CaptureReader


def scan_freqs(fs: int, fc: float, start_mhz: float | None,
               stop_mhz: float | None) -> list[float]:
    """The 25 kHz raster inside the span, clear of its edges and of DC."""
    guard = 2 * STEPRATE
    lo = fc - fs / 2 + guard
    hi = fc + fs / 2 - guard
    if start_mhz is not None:
        lo = max(lo, start_mhz * 1e6)
    if stop_mhz is not None:
        hi = min(hi, stop_mhz * 1e6)
    first = int(np.ceil(lo / STEPRATE)) * STEPRATE
    return [float(f) for f in range(first, int(hi), STEPRATE)
            if abs(f - fc) >= guard]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vdlm2t-torch-scan")
    ap.add_argument("--iq", required=True)
    ap.add_argument("--format", default="cu8",
                    choices=["cu8", "cs16", "cf32", "f32real"])
    ap.add_argument("--fs", type=int, default=2_000_000)
    ap.add_argument("--fc", type=float, required=True)
    ap.add_argument("--start", type=float, default=None, help="MHz")
    ap.add_argument("--stop", type=float, default=None, help="MHz")
    ap.add_argument("--max-rows", type=int, default=4)
    ap.add_argument("--block-seconds", type=float, default=1.0)
    ap.add_argument("--chan-impl", default=None,
                    choices=("matmul", "dft", "pfb"),
                    help="channelizer (default: residue-space dft when fc "
                         "sits on the 25 kHz raster, else matmul)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    freqs = scan_freqs(args.fs, args.fc, args.start, args.stop)
    if not freqs:
        print("no channel inside the span", file=sys.stderr)
        return 1
    print(f"# scanning {len(freqs)} channels "
          f"{freqs[0] / 1e6:.3f}..{freqs[-1] / 1e6:.3f} MHz", file=sys.stderr)
    chan_impl = args.chan_impl
    if chan_impl is None:
        on_raster = all((f - args.fc) % STEPRATE == 0 for f in freqs)
        chan_impl = "dft" if on_raster else "matmul"

    from .pipeline import Pipeline

    pipe = Pipeline(PipelineConfig(
        freqs_hz=freqs, fs=args.fs, fc_hz=args.fc,
        max_symbols=args.max_rows * 680 + 16, max_candidates=16,
        chan_impl=chan_impl), device=args.device)
    counts = dict.fromkeys(freqs, 0)
    for bursts in pipe.stream_wideband(CaptureReader(args.iq, args.format),
                                       block_seconds=args.block_seconds):
        for b in bursts:
            counts[b.freq_hz] += len(b.frames)
    for f in sorted(counts, key=lambda f: -counts[f]):
        if counts[f]:
            print(f"{f / 1e6:.3f} MHz: {counts[f]} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
