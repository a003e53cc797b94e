#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA decoder (vdlm2dec_tpu_torch) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printed as one JSON line with the card's name and power limit:
  card     nvidia-smi name and power limit, torch and CUDA versions
  build    nvcc of vdlm2dec_tpu_torch/csrc into a ctypes library
  capture  8 channels x 2 Msps x 10 s of impaired rtl_sdr cu8 traffic
           (bench.make_capture: ~9 bursts/s/channel)
  kernel   the sync-scan kernel against its plain PyTorch version, both
           modes, at the decimated block shapes of 2 s and 4 s blocks:
           max abs / rel difference, trigger sets, CUDA-event times
  slice    Pipeline.stream_wideband_u8 over the whole capture for
           sync_impl stream and fused (2 s blocks, 64 trigger slots per
           channel, 512 decode slots, 8-row bursts): decoded frames must
           equal the stimulus truth, no slot overflow, and the kernel must
           have been launched by the run
  cli      `python -m vdlm2dec_tpu_torch.cli ... -J -G -E -U` on the
           capture file (every CRC-valid frame of the random-content
           traffic prints a JSON line): its lines must equal what
           Pipeline + FrameDecoder emit in-process
Then the card line, the kernels' JSON line and, last, the result line.
Any failed check raises (non-zero exit).  Without a CUDA card it exits 2
and prints no result.

It imports only the port and, for the stimulus, bench.make_capture and
bench.to_u8 (bench imports jax only inside its benchmark functions), so
it runs from the repository root and nowhere else.
"""
import sys

sys.modules["jax"] = None        # the port must not need jax; fail loudly

import io
import json
import os
import subprocess
import tempfile
import time
from collections import Counter

import numpy as np
import torch

import bench
from vdlm2dec_tpu_torch import _build, cli
from vdlm2dec_tpu_torch._tables import (PipelineConfig, period_for,
                                        stream_geometry)
from vdlm2dec_tpu_torch.host_decoder import FrameDecoder
from vdlm2dec_tpu_torch.ops import sync
from vdlm2dec_tpu_torch.ops.channelizer import Channelizer
from vdlm2dec_tpu_torch.ops.demod import find_triggers
from vdlm2dec_tpu_torch.ops.ingest import raw_to_planes_split
from vdlm2dec_tpu_torch.pipeline import Pipeline

REPO = os.path.dirname(os.path.abspath(__file__))
FS = 2_000_000
N_CHAN = 8
SECONDS = 10.0
MAX_SYMBOLS = 5449               # 8-row bursts (MAX_BURST_SYMBOLS)
MAX_CANDIDATES = 64
MAX_OUT = 512
SLICE_BLOCK_S = 2.0
# kernel vs plain version: the same float32 operations in the same order
# (no FMA contraction in the kernel); stream mode's atan2f may round
# differently from torch.atan2 in the last ulp, which err (17 squared
# residuals) carries at rtol ~1e-6.  Stated as tests/test_fused_sync.py's.
ERR_TOL = (1e-4, 1e-4)           # (rtol, atol)
FR_TOL = (1e-4, 1e-5)
KERNEL_SOURCE = "vdlm2dec_tpu_torch/csrc/sync_scan.cu"
REPLACES = "vdlm2dec_tpu/ops/pallas_sync.py:82"


def emit(phase: str, card: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": card, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_string() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n: int = 10, warm: int = 3) -> float:
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


def trigger_diff(err_a, fr_a, err_b, fr_b) -> tuple[int, int]:
    """(triggers in a, flipped triggers): positions valid on one side
    only.  Raises unless each flip sits where a threshold test (e1 < 4,
    e0 > e1) is within the err tolerance."""
    sets = []
    for err, fr in ((err_a, fr_a), (err_b, fr_b)):
        t0, _of, _df, valid, _q = find_triggers(err, fr, MAX_CANDIDATES)
        t0, valid = t0.cpu().numpy(), valid.cpu().numpy()
        sets.append({(int(c), int(t0[c, k])) for c, k in zip(*np.nonzero(valid))})
    flips = sets[0] ^ sets[1]
    e = err_a.cpu().numpy()
    rtol, atol = ERR_TOL
    for c, t in flips:
        e0, e1 = float(e[c, t]), float(e[c, t - 2])
        tol = atol + rtol * abs(e1)
        check(abs(e1 - 4.0) <= tol or abs(e0 - e1) <= tol,
              f"trigger ({c}, {t}) differs away from the threshold")
    return len(sets[0]), len(flips)


def kernel_phase(card, raw, freqs, fc, block_seconds):
    """Kernel vs plain at the decimated shape of one streaming block."""
    ch = Channelizer([f - fc for f in freqs], fs=FS, device="cuda")
    _l, _r, core_p, total_p = stream_geometry(
        ch.p_in, ch.p_out, FS, MAX_SYMBOLS, block_seconds)
    lo = core_p * ch.p_in * 2                  # block 1: traffic on both sides
    seg = torch.from_numpy(raw[lo: lo + total_p * ch.p_in * 2].copy())
    y = ch(*raw_to_planes_split(seg.cuda(), ch.p_in), period0=0)
    torch.cuda.synchronize()
    out = {}
    for mode in sync.MODES:
        ref = sync.sync_scan_fused_ref if mode == "fused" \
            else sync.sync_scan_stream_ref
        err_k, fr_k = sync.sync_scan(y, mode)
        err_p, fr_p = ref(y)
        torch.cuda.synchronize()
        d_err = (err_k - err_p).abs()
        d_fr = (fr_k - fr_p).abs()
        for d, want, (rtol, atol), name in ((d_err, err_p, ERR_TOL, "err"),
                                           (d_fr, fr_p, FR_TOL, "fr")):
            check(bool((d <= atol + rtol * want.abs()).all()),
                  f"{mode} {name} outside rtol={rtol} atol={atol}")
        n_trig, n_flip = trigger_diff(err_k, fr_k, err_p, fr_p)
        check(n_trig > 0, f"{mode}: no triggers in the block")
        ms = cuda_ms(lambda: sync.sync_scan(y, mode))
        plain_ms = cuda_ms(lambda: ref(y))
        res = dict(mode=mode, shape=list(y.shape),
                   block_seconds=block_seconds,
                   err_max_abs=float(d_err.max()),
                   err_max_rel=float((d_err / err_p.abs().clamp(min=1e-30)).max()),
                   fr_max_abs=float(d_fr.max()),
                   fr_max_rel=float((d_fr / fr_p.abs().clamp(min=1e-30)).max()),
                   bit_exact=bool(torch.equal(err_k, err_p)
                                  and torch.equal(fr_k, fr_p)),
                   triggers=n_trig, trigger_flips_near_threshold=n_flip,
                   ms=ms, plain_ms=plain_ms)
        emit("kernel", card, **res)
        out[mode] = res
    return out


def slice_config(freqs, fc, sync_impl) -> PipelineConfig:
    return PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=FS, fc_hz=float(fc),
        max_candidates=MAX_CANDIDATES, max_symbols=MAX_SYMBOLS,
        max_out=MAX_OUT, sync_impl=sync_impl)


def slice_phase(card, raw, freqs, fc, truth):
    """The decode slice through Pipeline.stream_wideband_u8, both modes."""
    p_in, p_out = period_for(FS // 4000)
    span84 = (len(raw) // 2 // p_in) * p_out
    want = Counter((c, b) for c, b, p0, n in truth if p0 + n <= span84)
    pipes = {m: Pipeline(slice_config(freqs, fc, m), device="cuda")
             for m in sync.MODES}
    warm = raw[: 2 * int(SLICE_BLOCK_S * FS)]
    for pipe in pipes.values():                # builds tables, warms up
        for _ in pipe.stream_wideband_u8(warm, block_seconds=SLICE_BLOCK_S):
            pass
    torch.cuda.synchronize()

    sync.reset_launches()                      # counts of the main path
    for mode, pipe in pipes.items():
        before = dict(sync.launches)
        pipe.metrics = cli.PipelineMetrics()
        pipe._overflow_warned = False
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        bursts = [b for bs in pipe.stream_wideband_u8(
            raw, block_seconds=SLICE_BLOCK_S) for b in bs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = Counter((b.channel, bytes(bytearray(f[1:-3])))
                      for b in bursts for f in b.frames)
        m = pipe.metrics
        n_blocks = -(-len(raw) // 2 // pipe.core_raw_samples(SLICE_BLOCK_S))
        launched = {k: sync.launches[k] - before[k] for k in sync.MODES}
        res = dict(
            sync_impl=mode, blocks=n_blocks,
            frames=sum(got.values()), truth_bursts=sum(want.values()),
            recall=f"{sum((got & want).values())}/{sum(want.values())}",
            missed=sum((want - got).values()),
            extra=sum((got - want).values()),
            sync_candidates=m.sync_candidates,
            candidates_overflow=m.candidates_overflow,
            kernel_launches=launched[mode],
            wall_s=wall, msps=len(raw) // 2 / wall / 1e6,
            peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
        emit("slice", card, **res)
        check(got == want, f"{mode}: decoded frames differ from the truth")
        check(m.candidates_overflow == 0, f"{mode}: decode slots overflowed")
        check(launched[mode] == n_blocks,
              f"{mode}: {launched[mode]} kernel launches for {n_blocks} blocks")
        check(all(v == 0 for k, v in launched.items() if k != mode),
              f"{mode}: launched another mode's kernel")
    return dict(sync.launches)


def cli_phase(card, raw, freqs, fc):
    """The CLI on the capture file vs the same decode in-process."""
    with tempfile.TemporaryDirectory(prefix="vdl2_smoke_") as tmp:
        path = os.path.join(tmp, "cap.cu8")
        raw.tofile(path)
        argv = [*(f"{f / 1e6:.6f}" for f in freqs), "--iq", path,
                "--fc", str(fc), "-J", "-G", "-E", "-U", "--start-time", "0",
                "-i", "SMOKE"]
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "vdlm2dec_tpu_torch.cli",
                            *argv], capture_output=True, text=True,
                           timeout=900, cwd=REPO)
        wall = time.perf_counter() - t
        check(r.returncode == 0, f"cli exited {r.returncode}: {r.stderr[-2000:]}")
        got = [ln for ln in r.stdout.splitlines() if ln.strip()]

        args = cli.build_parser().parse_args(argv)
        cfg = cli.pipeline_config(
            args, cli.validate_freqs([int(f * 1e6) for f in args.freqs]))
        log = io.StringIO()
        out_cfg = cli.output_config(args, verbose=0)
        out_cfg.logfile = log
        dec = FrameDecoder(out_cfg, time_base=0.0)
        pipe = Pipeline(cfg, device="cuda")
        for bursts in pipe.stream_wideband_u8(
                cli.CaptureReader(path, "cu8").raw,
                block_seconds=args.block_seconds):
            for b in bursts:
                dec.process_burst(b)
        want = [ln for ln in log.getvalue().splitlines() if ln.strip()]
    emit("cli", card, lines=len(got), lines_in_process=len(want),
         identical=got == want, wall_s=wall,
         block_seconds=args.block_seconds, max_symbols=cfg.max_symbols,
         max_out=pipe._max_out())
    check(len(got) > 0, "the CLI printed no JSON line")
    check(got == want, "CLI JSON lines differ from the in-process decode")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 2
    card = card_string()
    emit("card", card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())

    t = time.perf_counter()
    _build.load()
    info = _build.build_info
    emit("build", card, library=info["library"], nvcc_s=info.get("nvcc_s"),
         load_s=time.perf_counter() - t,
         ptxas=[ln.strip() for ln in info.get("ptxas", "").splitlines()
                if "registers" in ln])

    t = time.perf_counter()
    wide, freqs, fc, truth = bench.make_capture(FS, N_CHAN, SECONDS)
    raw = bench.to_u8(wide)
    emit("capture", card, channels=N_CHAN, seconds=SECONDS, fc=fc,
         bursts=len(truth), synth_s=time.perf_counter() - t)

    kern = {s: kernel_phase(card, raw, freqs, fc, s) for s in (2.0, 4.0)}
    launches = slice_phase(card, raw, freqs, fc, truth)
    cli_phase(card, raw, freqs, fc)

    kernels = []
    for mode in sync.MODES:
        k2, k4 = kern[2.0][mode], kern[4.0][mode]
        kernels.append(dict(
            name=f"sync_scan[{mode}]", route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES, launches=launches[mode],
            max_abs_err=max(k2["err_max_abs"], k2["fr_max_abs"],
                            k4["err_max_abs"], k4["fr_max_abs"]),
            ms=k2["ms"], plain_ms=k2["plain_ms"]))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
