"""Per-route device times of one streaming block, on one CUDA card.

    python3 -m vdlm2dec_tpu_torch.stage_times      # from the repository root

The capture is chip_smoke.py's traffic (stimulus.make_capture: 8 channels
at 2 Msps) cut to 6 s, and the block is block 1 of a stream of 2 s
blocks, taken with each route's own geometry (32-period tiles under
use_pallas) and the slice's decode sizes.  For each channelizer route of
the fused streaming path (dft, matmul, pfb, and use_pallas, which is
matmul through the fused u8 channelizer kernel), for compute="bf16" on
the dft and matmul routes, for sync_impl="xla" (dft) and for the FIR
filter (dense matmul) it prints one JSON line of CUDA-event times, with
the raw block already on the card:

  front_ms    channelize_raw: ingest + channelizer (median of 10 after
              3 warm-ups)
  program_ms  wideband_raw_decode: the whole device program (median of
              5 after 2 warm-ups)

The FIR route's front here is the device part only: on the decoder's
path (stream_wideband) the host converts each segment to complex
samples first.  Two passes, the second in the opposite route order, so a
drift of the card's clocks shows as a difference between passes.  The
first line is the card's name and power limit.  Exits 2 without a CUDA
card.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from . import stimulus
from ._tables import PipelineConfig, stream_geometry
from .pipeline import Pipeline, channelize_raw, wideband_raw_decode

FS = 2_000_000
N_CHAN = 8
SECONDS = 6.0
BLOCK_S = 2.0
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


def cuda_ms(fn, n: int, warm: int) -> float:
    """Median of n CUDA-event timings of fn() after warm-up, in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def route_times(pipe: Pipeline, raw: np.ndarray) -> dict:
    """front_ms and program_ms of block 1 of the cu8 stream raw."""
    cfg, ch = pipe.cfg, pipe.channelizer
    lmarg_p, _r, core_p, total_p = stream_geometry(
        ch.p_in, ch.p_out, FS, cfg.max_symbols, BLOCK_S,
        align=32 if cfg.use_pallas else 1)
    lo = (core_p - lmarg_p) * ch.p_in * 2
    seg = torch.from_numpy(raw[lo: lo + total_p * ch.p_in * 2].copy()).cuda()

    def front():
        channelize_raw(seg, ch, "cu8", cfg.use_pallas)

    def program():
        wideband_raw_decode(seg, ch, "cu8", cfg.use_pallas,
                            cfg.max_candidates, cfg.max_symbols,
                            pipe._max_out(), lmarg_p * ch.p_out,
                            core_p * ch.p_out, sync_impl=cfg.sync_impl)

    return dict(chan_impl=cfg.chan_impl, use_pallas=cfg.use_pallas,
                compute=cfg.compute, sync_impl=cfg.sync_impl,
                filter_mode=cfg.filter_mode, periods=total_p,
                front_ms=cuda_ms(front, 10, 3),
                program_ms=cuda_ms(program, 5, 2))


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_times: no CUDA card visible to torch", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    wide, freqs, fc, _truth = stimulus.make_capture(FS, N_CHAN, SECONDS)
    raw = stimulus.to_u8(wide)
    pipes = {name: Pipeline(PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=FS, fc_hz=float(fc),
        max_candidates=64, max_symbols=5449, max_out=512, **kw),
        device="cuda") for name, kw in ROUTES.items()}
    for n_pass, names in enumerate((list(ROUTES), list(ROUTES)[::-1])):
        for name in names:
            print(json.dumps(dict(card=card, n_pass=n_pass, route=name,
                                  **route_times(pipes[name], raw))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
