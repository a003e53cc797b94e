"""Device times of one streaming block, on one CUDA card: per route, and
per stage of the device program.

    python3 -m vdlm2dec_tpu_torch.stage_times              # from the repository root
    python3 -m vdlm2dec_tpu_torch.stage_times --band       # the 760-channel band
    python3 -m vdlm2dec_tpu_torch.stage_times --channels 8 --seconds 2 --no-routes

The 8-channel capture is chip_smoke.py's traffic (stimulus.make_capture at
2 Msps) cut to three blocks, and the block is block 1 of a stream of
`--seconds` blocks (2 s), taken with each route's own geometry (32-period
tiles under use_pallas) and the slice's decode sizes.  `--band` is the
bench's whole-band leg instead (bench.BAND_LEG: 760 channels at 25 kHz
from a 20 Msps capture of 1 s, the filterbank ("pfb") channelizer, sync
"stream", 512 symbols), block 1 of a stream of 0.5 s blocks.

Per route (8 channels only; `--no-routes` leaves them out): for each
channelizer route of the fused streaming path (dft, matmul, pfb, and
use_pallas, which is matmul through the fused u8 channelizer kernel), for
compute="bf16" on the dft and matmul routes, for sync_impl="xla" (dft) and
for the FIR filter (dense matmul) one JSON line of CUDA-event times, with
the raw block already on the card:

  front_ms    channelize_raw: ingest + channelizer (median of 10 after
              3 warm-ups)
  program_ms  wideband_raw_decode: the whole device program (median of
              5 after 2 warm-ups)

The FIR route's front here is the device part only: on the decoder's
path (stream_wideband) the host converts each segment to complex
samples first.  Two passes, the second in the opposite route order, so a
drift of the card's clocks shows as a difference between passes.

Per stage (`stage_table`, one JSON line a shape): the device program
itself (pipeline.wideband_raw_decode, the default route of the shape)
runs with an observer that records a CUDA event where each stage's work
has been enqueued (pipeline.STAGES), so the times are those of the real
program, launch gaps included, and nothing is run twice or cut short:

  cum_ms      from the program's start to the stage's end, the median of
              5 runs after 2 warm-ups, with the least and the most beside
              it
  delta_ms    the stage alone (the median of each run's difference)
  kernels, copies, kernel_ms   from one more run, untimed, in which
              torch.profiler traces each stage by itself (the stream is
              drained at every boundary): kernel launches, memory copies
              and fills, and the sum of the kernels' own durations

The first line is the card's name and power limit.  Exits 2 without a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import stimulus
from ._tables import RAW_FMT, PipelineConfig, stream_geometry
from .kernel_times import card_string, event_ms
from .pipeline import STAGES, Pipeline, channelize_raw, wideband_raw_decode

FS = 2_000_000
ROUTES = {
    "dft": {"chan_impl": "dft"},
    "matmul": {"chan_impl": "matmul"},
    "pfb": {"chan_impl": "pfb"},
    "pallas": {"use_pallas": True},
    "dft_bf16": {"chan_impl": "dft", "compute": "bf16"},
    "matmul_bf16": {"chan_impl": "matmul", "compute": "bf16"},
    "xla": {"chan_impl": "dft", "sync_impl": "xla"},
    "fir": {"chan_impl": "matmul", "filter_mode": "fir"},
}


def block_segment(pipe: Pipeline, raw: np.ndarray, block_seconds: float,
                  i: int, fmt: str = "cu8"):
    """Block i of stream_wideband_u8's cut of the capture raw: (segment
    with its margins, padded beyond the capture as the stream pads it;
    core_start; core_len), the last two in decimated samples."""
    cfg, ch = pipe.cfg, pipe.channelizer
    per, pad_val = RAW_FMT[fmt]
    lmarg_p, _r, core_p, total_p = stream_geometry(
        ch.p_in, ch.p_out, cfg.fs, cfg.max_symbols, block_seconds,
        align=32 if cfg.use_pallas else 1)
    lo = (i * core_p - lmarg_p) * ch.p_in * per
    hi = lo + total_p * ch.p_in * per
    seg = np.full(hi - lo, pad_val, dtype=raw.dtype)
    s_lo, s_hi = max(lo, 0), min(hi, len(raw))
    if s_hi > s_lo:
        seg[s_lo - lo: s_hi - lo] = raw[s_lo:s_hi]
    return seg, lmarg_p * ch.p_out, core_p * ch.p_out


def block_program(pipe: Pipeline, raw: np.ndarray, block_seconds: float):
    """program(mark=None): the device program of block 1 of the cu8
    stream raw, staged on the pipeline's device, as dispatch_fused runs
    it; and the block's samples."""
    cfg, ch = pipe.cfg, pipe.channelizer
    seg, core_start, core_len = block_segment(pipe, raw, block_seconds, 1)
    seg_dev = torch.from_numpy(seg).to(pipe.device)

    def program(mark=None):
        return wideband_raw_decode(seg_dev, ch, "cu8", cfg.use_pallas,
                                   cfg.max_candidates, cfg.max_symbols,
                                   pipe._max_out(), core_start, core_len,
                                   sync_impl=cfg.sync_impl, mark=mark)

    return program, seg_dev, len(seg) // 2


def route_times(pipe: Pipeline, raw: np.ndarray,
                block_seconds: float) -> dict:
    """front_ms and program_ms of block 1 of the cu8 stream raw."""
    cfg, ch = pipe.cfg, pipe.channelizer
    program, seg_dev, n = block_program(pipe, raw, block_seconds)
    return dict(chan_impl=cfg.chan_impl, use_pallas=cfg.use_pallas,
                compute=cfg.compute, sync_impl=cfg.sync_impl,
                filter_mode=cfg.filter_mode, periods=n // ch.p_in,
                front_ms=event_ms(
                    lambda: channelize_raw(seg_dev, ch, "cu8",
                                           cfg.use_pallas), n=10, warm=3),
                program_ms=event_ms(program, n=5, warm=2))


def stage_events(program, runs: int = 5, warm: int = 2) -> list[dict]:
    """Per timed run, the ms from the program's start to each stage's
    mark (CUDA events on the current stream)."""
    out = []
    for r in range(warm + runs):
        events = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        mark("start")
        program(mark)
        torch.cuda.synchronize()
        if r >= warm:
            out.append({stage: events[0][1].elapsed_time(ev)
                        for stage, ev in events[1:]})
    return out


def stage_kernels(program) -> dict:
    """One untimed run with torch.profiler tracing each stage by itself:
    stage -> kernels launched, copies and fills, and the kernels' summed
    durations in ms.  The stream is drained at every boundary, so each
    trace holds its stage's work and no other."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts: dict = {}
    open_trace = []

    def begin():
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        open_trace.append(prof)

    def mark(stage):
        torch.cuda.synchronize()
        prof = open_trace.pop()
        prof.stop()
        on_card = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        kernels = [e for e in on_card
                   if not e.name.startswith(("Memcpy", "Memset"))]
        kernel_us = sum(getattr(e, "device_time", None)
                        or getattr(e, "cuda_time", 0.0) for e in kernels)
        counts[stage] = dict(kernels=len(kernels),
                             copies=len(on_card) - len(kernels),
                             kernel_ms=kernel_us / 1e3)
        begin()

    begin()
    try:
        program(mark)
    finally:
        open_trace.pop().stop()
    return counts


def stage_table(pipe: Pipeline, raw: np.ndarray,
                block_seconds: float) -> dict:
    """Per-stage device times and kernel counts of block 1 of the cu8
    stream raw through the pipeline's device program (see the module's
    docstring for the columns)."""
    if pipe.device.type != "cuda":
        raise ValueError("stage times are CUDA-event times: the pipeline "
                         f"is on {pipe.device}")
    cfg = pipe.cfg
    program, _seg, n = block_program(pipe, raw, block_seconds)
    with torch.cuda.device(pipe.device):
        timed = stage_events(program)
        counted = stage_kernels(program)
    rows = []
    prev = None
    for stage in STAGES:
        cum = [run[stage] for run in timed]
        delta = [run[stage] - (run[prev] if prev else 0.0) for run in timed]
        rows.append(dict(stage=stage, cum_ms=float(np.median(cum)),
                         cum_ms_spread=[min(cum), max(cum)],
                         delta_ms=float(np.median(delta)),
                         delta_ms_spread=[min(delta), max(delta)],
                         **counted[stage]))
        prev = stage
    program_ms = rows[-1]["cum_ms"]
    return dict(channels=len(cfg.freqs_hz), fs=cfg.fs,
                block_seconds=block_seconds, block_samples=n,
                chan_impl=cfg.chan_impl, sync_impl=cfg.sync_impl,
                compute=cfg.compute, max_candidates=cfg.max_candidates,
                max_symbols=cfg.max_symbols, max_out=pipe._max_out(),
                runs=len(timed), stages=rows, program_ms=program_ms,
                kernels=sum(r["kernels"] for r in rows),
                kernel_ms=sum(r["kernel_ms"] for r in rows),
                device_msps=n / program_ms / 1e3)


def slice_capture(channels: int, block_seconds: float):
    """(cu8 capture, freqs, fc): chip_smoke.py's traffic at `channels`
    channels, three blocks long."""
    wide, freqs, fc, _truth = stimulus.make_capture(FS, channels,
                                                    3 * block_seconds)
    return stimulus.to_u8(wide), freqs, fc


def slice_pipeline(freqs, fc, device, **route) -> Pipeline:
    """A pipeline over the slice's plan with the slice's decode sizes."""
    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=FS, fc_hz=float(fc),
        max_candidates=64, max_symbols=5449, max_out=512, **route)
    return Pipeline(cfg, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="seconds a streaming block (the capture is three "
                         "blocks long)")
    ap.add_argument("--band", action="store_true",
                    help="the whole-band shape: 760 channels, 20 Msps, pfb, "
                         "0.5 s blocks; the stage table only")
    ap.add_argument("--no-routes", dest="routes", action="store_false",
                    help="leave out the per-route lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_times: no CUDA card visible to torch", file=sys.stderr)
        return 2
    card = card_string()
    print(card, flush=True)
    if args.band:
        from .bench import BAND_BLOCK_S, BAND_LEG, leg_pipeline

        pipe, raw, _truth = leg_pipeline(
            **BAND_LEG, max_candidates=None, pallas=False, device="cuda",
            block_seconds=BAND_BLOCK_S)
        print(json.dumps(dict(card=card, shape="band", **stage_table(
            pipe, raw, BAND_BLOCK_S))), flush=True)
        return 0
    raw, freqs, fc = slice_capture(args.channels, args.seconds)
    if args.routes:
        pipes = {name: slice_pipeline(freqs, fc, "cuda", **kw)
                 for name, kw in ROUTES.items()}
        for n_pass, names in enumerate((list(ROUTES), list(ROUTES)[::-1])):
            for name in names:
                print(json.dumps(dict(
                    card=card, n_pass=n_pass, route=name,
                    **route_times(pipes[name], raw, args.seconds))),
                    flush=True)
    pipe = slice_pipeline(freqs, fc, "cuda")
    print(json.dumps(dict(card=card, shape="slice",
                          **stage_table(pipe, raw, args.seconds))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
