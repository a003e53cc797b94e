"""Benchmark of the PyTorch decoder: wideband IQ decode throughput, device
program times and serving latency on one CUDA card.

    python3 -m vdlm2dec_tpu_torch.bench              # every leg, on the card
    python3 -m vdlm2dec_tpu_torch.bench --quick      # the 8-channel legs, small
    python3 -m vdlm2dec_tpu_torch.bench --quick --device cpu --no-device

The twin of bench.py at the repository root (the JAX package's), with the
same stimulus (stimulus.make_capture: impaired bursts, per-burst CFO,
18 dB near-far spread, random phase and timing) and the same legs:

  primary        8 channels at 2 Msps through PipelinedDecoder: wall Msps
                 with the host-to-device copy of every block in the loop
  device_8ch     the device program alone on a block staged on the card
                 once (CUDA events), with the float32 matmul peak, the HBM
                 read rate and the channelizer's achieved operations
  scale_band_760ch, device_band_760ch
                 the whole VDL band: 760 channels at 25 kHz from a 20 Msps
                 capture, filterbank channelizer, streamed in --band-core
                 (0.5 s) blocks
  scale_2000ch   2000 channels from a synthetic 100 Msps capture in one
                 block, with bursts on both edge channels (0 and 1999)
  latency        paced real-time feed at 0.1 and 0.25 s blocks: p50 / p95 /
                 max turnaround, backlog, stalls, sustained
  fast_8ch_bf16_fused   bf16 channelizer operands + sync "fused"
  scale_64ch, scale_76ch   the residue-space channelizer at 25 kHz spacing
  analysis       (--analysis) per-stage device times, through
                 stage_times.stage_table

Every throughput leg first decodes its capture once and holds the result
to the per-burst recall gate (every synthesized burst inside the decoded
span back on its own channel with its exact bytes; a miss raises), then
times three passes, reports each (`msps_passes`) and takes the median; the
candidate-overflow counter of the timed passes must be 0.  A
leg that fails is reported as {"error": ...} and the process then exits
with code 1.

The full record goes to stderr and bench_full.json; stdout ends with one
compact JSON line: the headline, a summary of every leg, and the card's
name and power limit.  Times and rates are measurements of the device the
run names (`card`, `device`); the device legs need a CUDA card and raise
without one.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time
import traceback
from collections import Counter

import numpy as np
import torch

from . import stimulus
from ._tables import RAW_FMT, PipelineConfig, packed_stats
from .constants import STEPRATE
from .kernel_times import card_string
from .metrics import PipelineMetrics
from .pipeline import (Pipeline, PipelinedDecoder, _to_device, channelize_raw,
                       dispatch_fused, wideband_raw_decode)
from .stage_times import stage_table

PASSES = 3                       # timed passes a leg, each reported

# the legs' captures and plans (leg_pipeline's arguments).
# The whole VDL band, streamed in blocks of BAND_BLOCK_S (--band-core)
BAND_LEG = dict(channels=760, seconds=1.0, max_symbols=512, spacing=25_000,
                active_every=48, fs=20_000_000, base=118_500_000,
                chan_impl="pfb", sync_impl="stream")
BAND_BLOCK_S = 0.5
# 2000 channels x 25 kHz = a 50 MHz plan inside a synthetic 100 Msps capture
# (physical VDL tops out at 760 channels; this is the channel-count scaling
# endpoint, not a real band).  active_every=100 reaches channel 1900 only, so
# the top edge, channel 1999, is named besides: the highest |offset| LOs are
# where a channelizer or decimation defect shows first
KCHAN_LEG = dict(channels=2000, seconds=0.25, max_symbols=512, spacing=25_000,
                 active_every=100, also_active=(1999,), fs=100_000_000,
                 base=1_118_500_000, chan_impl="pfb", sync_impl="stream")
# both scale configs use 25 kHz spacing (at 50 kHz, 64 channels span 3.2 MHz,
# past the 2 Msps Nyquist); active channels sit 125 kHz apart: the 84 kHz
# decimation folds a neighbour at offset S to |S mod 84| kHz, and 125 kHz
# folds to 41 kHz, maximally far from the matched filter
SCALE_LEGS = {ch: dict(channels=ch, seconds=1.0, spacing=25_000,
                       active_every=5, chan_impl="dft") for ch in (64, 76)}
# decode slots a leg adds per channel and second of block for the junk
# triggers of channels without traffic (adjacent-channel leakage and images
# of strong bursts).  Counted on the legs' own captures through the plain
# versions: 3.4 a channel-second at 64 channels, 3.2 at 76, 1.2 on the band,
# 1.1 at 2000 channels.  The traffic term alone (the JAX bench's sizing) is
# short of every wide leg's candidates (314 for 281 slots at 64 channels,
# 507-561 for 348 on the band, 576 for 115 at 2000), which drops only
# junk, by rank, but counts as overflow
JUNK_SLOTS = 4


def leg_pipeline(channels: int, seconds: float, max_symbols: int,
                 max_candidates: int | None, pallas: bool, device,
                 spacing: int = 50_000, active_every: int = 1,
                 also_active: tuple[int, ...] = (), fs: int = 2_000_000,
                 base: int | None = None, chan_impl: str = "matmul",
                 compute: str = "f32", sync_impl: str = "stream",
                 block_seconds: float | None = None):
    """A leg's pipeline, its capture as cu8 bytes and the capture's
    truth: (pipe, raw, truth).  block_seconds is the span of one decode
    where it is not the whole capture."""
    wide, freqs, fc, truth = stimulus.make_capture(
        fs, channels, seconds, spacing=spacing, active_every=active_every,
        base=base, also_active=also_active)
    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=fs, fc_hz=float(fc),
        # the residue-space channelizers need the wrapped LO
        lo_wrap=(chan_impl in ("dft", "pfb", "auto")),
        max_candidates=max_candidates or max(16, int(16 * seconds)),
        max_symbols=max_symbols,
        use_pallas=pallas and chan_impl == "matmul",
        chan_impl=chan_impl, compute=compute, sync_impl=sync_impl,
        # decode slots sized for dense traffic on the active channels (~11
        # bursts/s/channel at median burst length, x2 headroom for
        # re-triggers, which occupy slots too) plus the junk allowance
        max_out=max(64, int(22 * seconds * channels // max(active_every, 1))
                    + int(22 * seconds * len(also_active))
                    + int(JUNK_SLOTS * (block_seconds or seconds) * channels)),
    )
    return Pipeline(cfg, device=device), stimulus.to_u8(wide), truth


def whole_tiles(pipe: Pipeline, raw: np.ndarray) -> np.ndarray:
    """The capture cut to whole channelizer periods (whole 32-period
    tiles under use_pallas)."""
    per = 2 * pipe.channelizer.p_in * (32 if pipe.cfg.use_pallas else 1)
    return raw[: len(raw) - len(raw) % per]


def device_card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, for a
    CUDA device; "cpu" otherwise."""
    return _card() if torch.device(device).type == "cuda" else "cpu"


@functools.lru_cache(maxsize=1)
def _card() -> str:
    return card_string()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _median(values: list[float]) -> float:
    return float(np.median(values))


def recall_gate(pipe: Pipeline, bursts, truth, t: int, label: str) -> dict:
    """Per-burst recall of a decode of the capture's first t samples:
    every synthesized burst must come back on its OWN channel with its
    exact content; anything else is a duplicate (same (channel, content)
    twice, e.g. a cross-block re-decode), leakage (right content, wrong
    channel, e.g. adjacent-channel or alias images) or spurious (content
    matching nothing synthesized).  Only bursts fully inside the decoded
    span count (use_pallas truncates t to 32-period tiles); a burst cut by
    the span's end can still decode when RS corrects the missing samples,
    and counts as "edge".  Raises on a miss."""
    ch = pipe.channelizer
    span84 = t // ch.p_in * ch.p_out
    in_span = [(c, cb) for c, cb, p0, pl in truth if p0 + pl <= span84]
    out_span_keys = {(c, cb) for c, cb, p0, pl in truth if p0 + pl > span84}
    n_bursts = len(in_span)
    want = Counter(in_span)
    got = Counter()
    for b in bursts:
        for f in b.frames:
            got[(b.channel, bytes(bytearray(f[1:-3])))] += 1
    matched = sum(min(got[k], n) for k, n in want.items())
    missed = n_bursts - matched
    duplicates = sum(max(got[k] - want[k], 0) for k in got if k in want)
    contents = {c for _ch, c in want}
    stray = {k: n for k, n in got.items() if k not in want}
    edge = sum(n for k, n in stray.items() if k in out_span_keys)
    leakage = sum(n for k, n in stray.items()
                  if k not in out_span_keys and k[1] in contents)
    spurious = sum(n for k, n in stray.items()
                   if k not in out_span_keys and k[1] not in contents)
    n_frames = sum(len(b.frames) for b in bursts)
    print(f"# [{label}] recall {matched}/{n_bursts} (missed {missed}, "
          f"duplicates {duplicates}, leakage {leakage}, spurious {spurious}, "
          f"edge {edge}; {n_frames} frames)", file=sys.stderr)
    if missed:
        raise RuntimeError(
            f"{label} recall failure: {missed}/{n_bursts} synthesized "
            f"bursts not recovered on their own channel")
    return {"frames": n_frames, "bursts": n_bursts,
            "recall": f"{matched}/{n_bursts}", "duplicates": duplicates,
            "leakage": leakage, "spurious": spurious, "edge": edge}


def _profiler(profile_dir: str | None):
    """torch.profiler over the timed loop, its trace written to
    profile_dir/trace.json; a null context without a directory."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(
        activities=acts,
        on_trace_ready=lambda p: p.export_chrome_trace(
            os.path.join(profile_dir, "trace.json")))


def run_config(channels: int, seconds: float, iters: int, max_symbols: int,
               max_candidates: int | None, pallas: bool, device="cuda",
               profile_dir: str | None = None,
               block_seconds: float | None = None, **leg) -> dict:
    """Wall throughput of one config (run_leg) on its own capture.  leg:
    leg_pipeline's other arguments."""
    pipe, raw, truth = leg_pipeline(channels, seconds, max_symbols,
                                    max_candidates, pallas, device,
                                    block_seconds=block_seconds, **leg)
    return run_leg(pipe, raw, truth, iters, profile_dir, block_seconds)


def run_leg(pipe: Pipeline, raw: np.ndarray, truth, iters: int,
            profile_dir: str | None = None,
            block_seconds: float | None = None) -> dict:
    """Wall throughput of a pipeline on its cu8 capture: the recall gate
    on a first decode, then PASSES timed passes of `iters` decodes of the
    capture, through PipelinedDecoder (one block a decode) or, with
    block_seconds, through stream_wideband_u8 in blocks of that size."""
    fs = pipe.cfg.fs
    channels = len(pipe.cfg.freqs_hz)
    label = f"{channels}ch"
    raw_u8 = whole_tiles(pipe, raw)
    t = len(raw_u8) // 2
    cuda = pipe.device.type == "cuda"

    # correctness gate + warm-up of the exact timed program
    pipe.metrics = PipelineMetrics()
    if block_seconds:
        bursts = [b for bs_ in pipe.stream_wideband_u8(
            raw_u8, block_seconds=block_seconds) for b in bs_]
    else:
        bursts = pipe._finish(pipe.decode_wideband_u8(raw_u8), 0)
    stats = recall_gate(pipe, bursts, truth, t, label)
    warm_overflow = pipe.metrics.candidates_overflow

    pipe.metrics = PipelineMetrics()
    if cuda:
        torch.cuda.reset_peak_memory_stats(pipe.device)
    dts = []
    with _profiler(profile_dir):
        for _pass in range(PASSES):
            t0 = time.perf_counter()
            if block_seconds:
                # stream fixed core blocks through the pipelined fused
                # program (the production streaming shape)
                for _ in range(iters):
                    for _bursts in pipe.stream_wideband_u8(
                            raw_u8, block_seconds=block_seconds):
                        pass
            else:
                # the fetch thread behind the dispatcher overlaps the
                # copies and the host's unpacking with device compute
                pd = PipelinedDecoder(pipe)
                n_res = 0
                try:
                    for _ in range(iters):
                        n_res += sum(1 for _c in pd.submit(raw_u8))
                    n_res += sum(1 for _c in pd.drain())
                finally:
                    pd.close()
                if n_res != iters:
                    raise RuntimeError(f"{label}: {n_res} results for "
                                       f"{iters} blocks")
            _sync(pipe.device)
            dts.append(time.perf_counter() - t0)
    overflow = pipe.metrics.candidates_overflow
    if overflow or warm_overflow:
        raise RuntimeError(
            f"{label}: {overflow} sync candidates dropped in the timed "
            f"passes ({warm_overflow} in the first decode): decode slots "
            f"exhausted (max_out={pipe._max_out()})")

    msps_passes = [t * iters / dt / 1e6 for dt in dts]
    msps = _median(msps_passes)
    # one card replaces this many real-time reference instances at this
    # channel count: channels x (achieved rate / the capture's own rate)
    chan_rt = channels * msps / (fs / 1e6)
    print(f"# [{label}] {PASSES} passes of {iters} x {t} samples: "
          f"{msps:.1f} Msps (median; passes "
          f"{[round(m, 1) for m in msps_passes]}) = {chan_rt:.0f} "
          f"channel-realtime equivalents", file=sys.stderr)
    out = {"channels": channels, "msps": round(msps, 2),
           "msps_passes": [round(m, 2) for m in msps_passes],
           "channel_realtime_equivalents": round(chan_rt, 0), **stats,
           "candidates_overflow": overflow,
           "sync_candidates": pipe.metrics.sync_candidates,
           "block_samples": t, "iters": iters, "max_out": pipe._max_out(),
           "chan_impl": pipe.cfg.chan_impl, "sync_impl": pipe.cfg.sync_impl,
           "compute": pipe.cfg.compute, "use_pallas": pipe.cfg.use_pallas,
           "device": str(pipe.device), "card": device_card(pipe.device)}
    if block_seconds:
        out["block_seconds"] = block_seconds
    if cuda:
        out["peak_mem_mb"] = round(
            torch.cuda.max_memory_allocated(pipe.device) / 2**20, 1)
    return out


def packed_checksum(packed: np.ndarray) -> int:
    """uint32 sum over the bit-exact bytes of packed rows: the burst
    blocks and RS counts and the integer meta words, not the float of /
    df words (7-8), so that two legs of one shape can be told equal."""
    cols = np.r_[0:2048, 2048:2076, 2084:2096]
    return int(packed[:, cols].sum(dtype=np.uint64) & 0xFFFFFFFF)


def _event_ms(fn, device) -> float:
    """One fn() between two CUDA events on the device's stream, in ms."""
    with torch.cuda.device(device):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
    return a.elapsed_time(b)


def _need_cuda(pipe: Pipeline, what: str) -> None:
    if pipe.device.type != "cuda":
        raise ValueError(f"{what} is timed with CUDA events: the pipeline "
                         f"is on {pipe.device}")


def run_device_config(channels: int, seconds: float, outer: int, inner: int,
                      max_symbols: int, max_candidates: int | None,
                      pallas: bool, device="cuda", mfu: bool = True,
                      probe_seconds: float | None = None, **leg) -> dict:
    """The device program alone: the raw block staged on the card ONCE,
    then `outer` passes (each reported) of `inner` whole decodes between
    two CUDA events; no copy and no host finishing in the timed region.
    probe_seconds cuts the capture to its first part.  mfu adds the
    roofline probes of _mfu_probes.  Raises if the block's candidates
    overflow the decode slots."""
    pipe, raw, _truth = leg_pipeline(channels, seconds, max_symbols,
                                     max_candidates, pallas, device,
                                     block_seconds=probe_seconds, **leg)
    _need_cuda(pipe, "the device leg")
    cfg, ch = pipe.cfg, pipe.channelizer
    if probe_seconds is not None:
        raw = raw[: 2 * int(probe_seconds * cfg.fs)]
    raw = whole_tiles(pipe, raw)
    t = len(raw) // 2
    raw_dev = _to_device(raw, pipe.device)

    def program():
        return wideband_raw_decode(
            raw_dev, ch, "cu8", cfg.use_pallas, cfg.max_candidates,
            cfg.max_symbols, pipe._max_out(), sync_impl=cfg.sync_impl)

    def decodes():
        for _ in range(inner):
            program()

    packed = program().cpu().numpy()                 # warm-up
    overflow = packed_stats(packed)["candidates_overflow"]
    if overflow:
        raise RuntimeError(
            f"device {channels}ch: {overflow} sync candidates dropped: "
            f"decode slots exhausted (max_out={pipe._max_out()})")
    torch.cuda.reset_peak_memory_stats(pipe.device)
    # each pass timed separately: the spread inside one record is what
    # lets a reader tell a regression from the host's load
    msps_passes = sorted(t * inner / _event_ms(decodes, pipe.device) / 1e3
                         for _ in range(outer))
    dev_msps = _median(msps_passes)
    chan_rt = channels * dev_msps / (cfg.fs / 1e6)
    card = device_card(pipe.device)
    out = {"channels": channels, "device_msps": round(dev_msps, 2),
           "device_msps_passes": [round(m, 2) for m in msps_passes],
           "channel_realtime_equivalents": round(chan_rt, 0),
           "blocks_timed": outer * inner, "block_samples": t,
           "checksum": packed_checksum(packed),
           "candidates_overflow": overflow,
           "peak_mem_mb": round(
               torch.cuda.max_memory_allocated(pipe.device) / 2**20, 1),
           "max_out": pipe._max_out(),
           "chan_impl": cfg.chan_impl, "sync_impl": cfg.sync_impl,
           "device": str(pipe.device), "card": card}
    print(f"# [device {channels}ch] {outer * inner} x {t} samples: "
          f"{dev_msps:.1f} Msps device program (median; passes "
          f"{[round(m, 1) for m in msps_passes]}) = {chan_rt:.0f} "
          f"channel-realtime equivalents [{card}]", file=sys.stderr)
    if mfu:
        out.update(_mfu_probes(pipe, raw_dev))
    return out


def _mfu_probes(pipe: Pipeline, raw_dev: torch.Tensor) -> dict:
    """Roofline context beside a device leg, all CUDA-event times: the
    float32 matmul rate with TF32 off (as the decoder multiplies), the
    device-memory read rate, and the channelizer front alone
    (channelize_raw on the staged block) with the operations of the
    implementation in use.  The share is a per-layer figure of the front,
    not a share of the whole step."""
    _need_cuda(pipe, "the roofline probe")
    dev = pipe.device
    ch = pipe.channelizer
    reps, n_pass = 8, 3

    def rate(fn, work) -> float:
        fn()                                         # warm-up
        return _median([work * reps / (_event_ms(
            lambda: [fn() for _ in range(reps)], dev) / 1e3)
            for _ in range(n_pass)])

    k = 4096
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((k, k), generator=gen, device=dev)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on: the float32 peak would not be the "
                           "decoder's")
    matmul_flops = rate(lambda: a @ a, 2 * k**3)
    del a
    big = torch.ones((256, 1 << 20), device=dev)     # 1 GiB
    hbm_read = rate(big.sum, big.numel() * 4)
    del big

    def front():
        return channelize_raw(raw_dev, ch, "cu8", pipe.cfg.use_pallas)

    front()
    ch_dt = _median([_event_ms(lambda: [front() for _ in range(reps)], dev)
                     for _ in range(n_pass)]) / reps / 1e3
    c = len(ch.f_offsets)
    p_in, p_out = ch.p_in, ch.p_out
    t = raw_dev.numel() // RAW_FMT["cu8"][0]
    nb = t // p_in
    # the operations of the implementation in use (dft and pfb do the same
    # products in far fewer multiply-adds than the dense form).  Residue
    # contraction of both residue implementations: 2 planes x 2*p_in*84
    # flops a period
    z_f = 4 * p_in * p_out * nb
    if ch.impl == "dft":
        achieved_f = z_f + 8 * c * (ch.fs // STEPRATE) * nb * p_out
    elif ch.impl == "pfb":
        fa, fb = ch.pfb_dfa.shape[0], ch.pfb_dfb.shape[0]
        achieved_f = z_f + (8 * fa * (fa + fb) * fb
                            + 6 * fa * fb) * nb * p_out
    else:
        # mix 12 flops/(chan, sample) + aggregate matmul 4*P_out each
        achieved_f = c * t * (12 + 4 * p_out)
    achieved = achieved_f / ch_dt
    # what the dense mix + dump formulation would need for the same output,
    # per second: the comparator across implementations
    dense_equiv = c * t * (12 + 4 * p_out) / ch_dt
    out = {
        "matmul_peak_gflops_f32": round(matmul_flops / 1e9, 1),
        "hbm_read_gbps": round(hbm_read / 1e9, 1),
        "channelize_ms": round(ch_dt * 1e3, 4),
        "channelizer_impl": "pallas" if pipe.cfg.use_pallas else ch.impl,
        "channelizer_gflops": round(achieved / 1e9, 1),
        "channelizer_dense_equiv_gflops": round(dense_equiv / 1e9, 1),
        "channelizer_share_of_matmul_peak": round(achieved / matmul_flops, 4),
    }
    print(f"# [device {c}ch] float32 matmul {out['matmul_peak_gflops_f32']} "
          f"Gflop/s (TF32 off), HBM read {out['hbm_read_gbps']} GB/s, "
          f"channelize {out['channelize_ms']} ms = "
          f"{out['channelizer_gflops']} Gflop/s (share of the matmul rate "
          f"{out['channelizer_share_of_matmul_peak']}) "
          f"[{device_card(dev)}]", file=sys.stderr)
    return out


def run_analysis(seconds: float, max_symbols: int, pallas: bool,
                 device="cuda", channels: int = 8, chan_impl: str = "auto",
                 compute: str = "f32", sync_impl: str = "stream") -> dict:
    """Per-stage device times and kernel counts of one block of `seconds`
    of the primary leg's shape, from stage_times.stage_table."""
    # a capture of three blocks (the table's block is the middle one),
    # the slots of one block, as the primary leg sizes them
    pipe, raw, _truth = leg_pipeline(
        channels, 3 * seconds, max_symbols, max(16, int(16 * seconds)),
        pallas, device, chan_impl=chan_impl, compute=compute,
        sync_impl=sync_impl, block_seconds=seconds)
    ana = stage_table(pipe, raw, seconds)
    ana["card"] = device_card(pipe.device)
    print(f"# analysis {json.dumps(ana)}", file=sys.stderr)
    return ana


def measure_h2d(pipe: Pipeline, raw: np.ndarray, n: int = 5) -> float:
    """ms of one block's copy from pageable host memory to the card, as
    dispatch_fused makes it (the median of n): the floor under a block's
    turnaround on this machine."""
    _need_cuda(pipe, "the host-to-device copy")
    times = []
    for _ in range(n + 1):
        _sync(pipe.device)
        t0 = time.perf_counter()
        _to_device(raw, pipe.device)
        _sync(pipe.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times[1:])


def run_latency(block_seconds: float, seconds: float = 8.0,
                channels: int = 8, max_symbols: int = 512,
                device="cuda") -> dict:
    """Serving latency: steady-state per-block turnaround (dispatch of a
    raw block -> its candidates on the host) through PipelinedDecoder.
    End-to-end burst latency on a live feed is bounded by one block
    period (buffering) + this turnaround.

    Blocks are submitted PACED at real time (block i at t_start +
    i*block_seconds, like a live SDR feed).  The schedule is rebased on
    the first completion, so that what is left of the warm-up cannot
    leave it in the past for good; every block submitted before that
    moment is warm-up and dropped from the record.  After it the record
    carries backlog evidence: completion lag against the schedule over
    the run (flat = keeping up, growing = falling behind: `sustained`),
    the deepest backlog, and `stalls`, the submits that found their feed
    time already past."""
    wide, freqs, fc, _truth = stimulus.make_capture(
        2_000_000, channels, seconds, spacing=25_000, active_every=5)
    cfg = PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=2_000_000, fc_hz=float(fc),
        max_symbols=max_symbols, max_candidates=8)
    pipe = Pipeline(cfg, device=device)
    core = pipe.core_raw_samples(block_seconds)
    raw = stimulus.to_u8(wide)
    n_blocks = len(wide) // core
    # tables, the kernels' build and the allocator, before anything is timed
    dispatch_fused(pipe, raw[: 2 * core], "cu8", 0, 0).cpu()

    pd = PipelinedDecoder(pipe)
    lat: list[float] = []
    done_lag: list[float] = []           # completion time - block's feed time
    t_sub: dict[int, float] = {}
    max_backlog = stalls = 0
    t_start = time.perf_counter()
    first_paced = None                   # first block on the rebased schedule

    def record(now: float, seen: int) -> None:
        lat.append(now - t_sub[seen])
        done_lag.append(now - (t_start + seen * block_seconds))

    try:
        seen = 0
        for i in range(n_blocks):
            feed_t = t_start + i * block_seconds
            now = time.perf_counter()
            if now < feed_t:             # a live feed delivers on schedule
                time.sleep(feed_t - now)
            elif first_paced is not None and i > first_paced:
                stalls += 1              # block first_paced is due at once
            t_sub[i] = time.perf_counter()
            if first_paced is not None:
                max_backlog = max(max_backlog, i + 1 - seen)
            for _res in pd.submit(raw[2 * i * core: 2 * (i + 1) * core]):
                now = time.perf_counter()
                record(now, seen)
                seen += 1
                if first_paced is None:
                    t_start = now - (i + 1) * block_seconds
                    first_paced = i + 1
        for _res in pd.drain():
            record(time.perf_counter(), seen)
            seen += 1
    finally:
        pd.close()
    # drop every block submitted before the rebase: its lag was taken
    # against a schedule it was not fed on
    warmup = n_blocks if first_paced is None else first_paced
    lat, done_lag = lat[warmup:], done_lag[warmup:]
    if not lat:
        return {"error": "capture too short for latency mode"}
    # sustained = completion lag does not grow over the run: the median
    # lag of the last quarter against the first quarter's.  A pipeline
    # that keeps up has flat lag (~ steady turnaround); one that falls
    # behind accrues ~(turnaround - period) per block
    q = max(1, len(done_lag) // 4)
    lag_head = sorted(done_lag[:q])[q // 2]
    lag_tail = sorted(done_lag[-q:])[len(done_lag[-q:]) // 2]
    sustained = lag_tail - lag_head < 0.5 * block_seconds
    lat = sorted(lat)

    def pct(p: float) -> float:
        return lat[min(len(lat) - 1, int(p * len(lat)))]

    out = {"block_seconds": block_seconds, "blocks": len(lat),
           "warmup_blocks": warmup,
           "p50_ms": round(pct(0.50) * 1e3, 2),
           "p95_ms": round(pct(0.95) * 1e3, 2),
           "max_ms": round(lat[-1] * 1e3, 2),
           "paced_realtime": True,
           "max_backlog_blocks": max_backlog,
           "stalls": stalls,
           "lag_first_quarter_ms": round(lag_head * 1e3, 2),
           "lag_last_quarter_ms": round(lag_tail * 1e3, 2),
           "sustained": bool(sustained),
           "device": str(pipe.device), "card": device_card(pipe.device)}
    if pipe.device.type == "cuda":
        out["h2d_block_ms"] = round(measure_h2d(pipe, raw[: 2 * core]), 4)
    print(f"# latency @{block_seconds}s blocks: p50 {out['p50_ms']} ms, "
          f"p95 {out['p95_ms']} ms, max {out['max_ms']} ms "
          f"({len(lat)} blocks, paced; backlog<={max_backlog}, {stalls} "
          f"stalls, lag {out['lag_first_quarter_ms']}->"
          f"{out['lag_last_quarter_ms']} ms, sustained={sustained}) "
          f"[{out['card']}]", file=sys.stderr)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decode (default cuda; the "
                         "device legs need a CUDA card)")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes: the 8-channel legs at 0.25 s")
    # 4 s blocks amortise the per-block host work
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--max-symbols", type=int, default=2048)
    ap.add_argument("--max-candidates", type=int, default=None,
                    help="sync candidates per channel (default: 16/s)")
    # tri-state: None (default) = whatever --chan-impl resolves to;
    # --pallas = the dense channelizer through the fused u8 channelizer
    # kernel; --no-pallas = never
    ap.add_argument("--pallas", dest="pallas", action="store_true",
                    default=None,
                    help="the fused u8 channelizer kernel (implies "
                         "--chan-impl matmul)")
    ap.add_argument("--no-pallas", dest="pallas", action="store_false",
                    help="never the fused u8 channelizer kernel")
    ap.add_argument("--chan-impl", default="auto",
                    choices=["auto", "matmul", "dft", "pfb"],
                    help="auto (the decoder's default) = residue-space dft "
                         "on eligible plans; dft/matmul/pfb force one")
    ap.add_argument("--compute", default="f32", choices=["f32", "bf16"],
                    help="bf16 channelizer operands (float32 sums)")
    ap.add_argument("--sync-impl", default="stream",
                    choices=["xla", "stream", "fused"],
                    help="the sync kernel's numeric mode; xla = stream's "
                         "metric and the flat demod on the materialized "
                         "four-branch filter")
    ap.add_argument("--no-scale-configs", dest="scale", action="store_false",
                    help="skip the 64/76-channel and bf16+fused configs")
    ap.set_defaults(scale=True)
    ap.add_argument("--band-core", type=float, default=BAND_BLOCK_S,
                    help="whole-band streaming core seconds per block")
    # default=None sentinel: --quick disables the band leg only when the
    # user did not explicitly ask for it
    ap.add_argument("--band", action="store_true", default=None,
                    help="the whole-VDL-band config: 760 channels at 25 kHz "
                         "across 118.5-137.5 MHz from a 20 Msps capture "
                         "(default on; skipped past --band-budget-s)")
    ap.add_argument("--no-band", dest="band", action="store_false",
                    help="skip the whole-band config")
    ap.add_argument("--no-device", dest="device_legs", action="store_false",
                    help="skip the device-program legs (staged input, CUDA "
                         "events, roofline probes)")
    ap.set_defaults(device_legs=True)
    ap.add_argument("--band-budget-s", type=float, default=1100.0,
                    help="start the whole-band config only if wall time is "
                         "below this")
    ap.add_argument("--kchan", action="store_true", default=None,
                    help="the 2000-channel config from a synthetic 100 Msps "
                         "capture (default on, off under --quick; skipped "
                         "past --kchan-budget-s)")
    ap.add_argument("--no-kchan", dest="kchan", action="store_false",
                    help="skip the 2000-channel config")
    ap.add_argument("--kchan-budget-s", type=float, default=1300.0,
                    help="start the 2000-channel config only if wall time "
                         "is below this")
    # one tri-state dest: None = default points, "all" = every block
    # size, "off" = skip
    ap.add_argument("--latency", dest="latency", action="store_const",
                    const="all", default=None,
                    help="per-block turnaround at ALL of 0.1/0.25/0.5/1 s "
                         "blocks; by default the 0.1 s and 0.25 s points")
    ap.add_argument("--no-latency", dest="latency", action="store_const",
                    const="off", help="skip the latency points")
    ap.add_argument("--analysis", action="store_true",
                    help="per-stage device times and kernel counts")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the primary "
                         "leg's timed loop to DIR/trace.json (its rates "
                         "then carry the profiler's cost)")
    ap.add_argument("--budget-s", type=float, default=1500.0,
                    help="skip remaining configs when past this wall time")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA card visible to torch (--device cpu decodes "
              "on the CPU, without the device legs)", file=sys.stderr)
        return 2
    if dev.type != "cuda" and (args.device_legs or args.analysis):
        print("bench: the device legs and --analysis are CUDA-event times; "
              "pass --no-device with --device cpu", file=sys.stderr)
        return 2
    card = device_card(dev)
    if args.quick:
        # 512 symbols covers the largest synthesized burst (120-byte
        # content -> ~460 symbols)
        args.seconds, args.iters, args.max_symbols = 0.25, 2, 512
        args.scale = False
        if args.band is None:           # an explicit --band survives --quick
            args.band = False
        if args.latency is None:
            args.latency = "off"
    if args.pallas and args.chan_impl == "auto":
        args.chan_impl = "matmul"
    args.pallas = bool(args.pallas)

    t_start = time.perf_counter()
    extra: dict = {}
    failed: list[str] = []

    def elapsed() -> float:
        return time.perf_counter() - t_start

    def leg(name: str, fn, cutoff: float = args.budget_s):
        """Run one leg into extra[name]: skipped past its budget; a
        failure is recorded as {"error": ...} and fails the run."""
        if elapsed() > cutoff:
            print(f"# past budget ({cutoff:.0f}s), skipping {name}",
                  file=sys.stderr)
            extra[name] = {"skipped": f"past budget ({cutoff:.0f}s)"}
            return
        try:
            extra[name] = fn()
        except Exception as e:           # reported, then a non-zero exit
            traceback.print_exc(file=sys.stderr)
            print(f"# {name} failed: {e}", file=sys.stderr)
            extra[name] = {"error": str(e)}
            failed.append(name)

    common = dict(device=dev, compute=args.compute)
    leg("primary", lambda: run_config(
        args.channels, args.seconds, args.iters, args.max_symbols,
        args.max_candidates, args.pallas, profile_dir=args.profile, chan_impl=args.chan_impl,
        sync_impl=args.sync_impl, **common))
    primary = extra.pop("primary")
    if args.device_legs:
        # the primary's device program alone: same config, the copies and
        # the host out of the loop
        leg("device_8ch", lambda: run_device_config(
            args.channels, args.seconds, 3, 4, args.max_symbols,
            args.max_candidates, args.pallas, chan_impl=args.chan_impl,
            sync_impl=args.sync_impl, **common))
    band_cutoff = min(args.budget_s, args.band_budget_s)
    if args.band is None or args.band:
        # the filterbank channelizer is the formulation that scales here:
        # the dense mix would materialize a (760, B, 20000) intermediate
        leg("scale_band_760ch", lambda: run_config(
            iters=2, max_candidates=args.max_candidates, pallas=False,
            block_seconds=args.band_core, **BAND_LEG, **common), band_cutoff)
        if args.device_legs and "msps" in extra["scale_band_760ch"]:
            # one --band-core block staged on the card
            leg("device_band_760ch", lambda: run_device_config(
                outer=3, inner=2, max_candidates=args.max_candidates,
                pallas=False, probe_seconds=args.band_core, **BAND_LEG,
                **common), band_cutoff)
    kchan_on = args.kchan if args.kchan is not None else not args.quick
    if kchan_on:
        leg("scale_2000ch", lambda: run_config(
            iters=2, max_candidates=args.max_candidates, pallas=False,
            **KCHAN_LEG, **common), min(args.budget_s, args.kchan_budget_s))
    lat_points = ((0.1, 0.25, 0.5, 1.0) if args.latency == "all"
                  else () if args.latency == "off" else (0.1, 0.25))
    if lat_points:
        leg("latency", lambda: [run_latency(bs, device=dev)
                                for bs in lat_points])
    if args.scale and args.compute == "f32":
        # the opt-in fast path (bf16 operands + the fused sync mode) next
        # to the parity-default primary
        leg("fast_8ch_bf16_fused", lambda: run_config(
            args.channels, args.seconds, args.iters, args.max_symbols,
            args.max_candidates, False, device=dev,
            chan_impl=args.chan_impl, compute="bf16", sync_impl="fused"))
    if args.scale:
        for ch, plan in SCALE_LEGS.items():
            leg(f"scale_{ch}ch", lambda plan=plan: run_config(
                iters=4, max_symbols=args.max_symbols,
                max_candidates=args.max_candidates, pallas=False,
                sync_impl=args.sync_impl, **plan, **common))
    if args.analysis:
        leg("analysis", lambda: run_analysis(
            args.seconds, args.max_symbols, args.pallas, device=dev,
            channels=args.channels, chan_impl=args.chan_impl,
            compute=args.compute, sync_impl=args.sync_impl))

    extra["stimulus"] = ("impaired: per-burst CFO uniform +-400 Hz "
                         "(+-3 ppm), 18 dB near-far level spread (1-8 u8 "
                         "LSB), random carrier phase + fractional-sample "
                         "timing (recall gate covers the sync/CFO/timing "
                         "estimators)")
    value = primary.get("msps")
    full = {
        "metric": "wideband_iq_decode_throughput",
        "value": value,
        "unit": "Msamples/s/card",
        "vs_baseline": None if value is None else round(value / 2.0, 2),
        "card": card,
        "device": str(dev),
        "primary": primary,
        "extra": extra,
    }
    # the FULL record goes to stderr and bench_full.json; stdout gets ONE
    # COMPACT line with the headline + a summary of every major leg, so
    # that a reader of the output's tail always finds it whole
    print(f"# full {json.dumps(full)}", file=sys.stderr)
    try:
        with open("bench_full.json", "w") as fh:
            json.dump(full, fh, indent=1)
    except OSError as e:
        print(f"# bench_full.json not written: {e}", file=sys.stderr)
    summary: dict = {}

    def _leg(name, src, *fields):
        if not isinstance(src, dict):
            return
        vals = {k: src[k] for k in fields if k in src}
        if "error" in src:
            vals["error"] = str(src["error"])[:60]
        if "skipped" in src:
            vals["skipped"] = True
        if vals:
            summary[name] = vals

    _leg("primary", primary, "recall", "msps_passes")
    _leg("dev8", extra.get("device_8ch"), "device_msps",
         "device_msps_passes", "channelizer_share_of_matmul_peak",
         "matmul_peak_gflops_f32", "hbm_read_gbps")
    _leg("band", extra.get("scale_band_760ch"), "msps",
         "channel_realtime_equivalents", "recall")
    _leg("devband", extra.get("device_band_760ch"), "device_msps",
         "device_msps_passes", "channelizer_share_of_matmul_peak")
    _leg("kchan", extra.get("scale_2000ch"), "msps",
         "channel_realtime_equivalents", "recall")
    _leg("fast", extra.get("fast_8ch_bf16_fused"), "msps", "recall")
    for ch in SCALE_LEGS:
        _leg(f"ch{ch}", extra.get(f"scale_{ch}ch"), "msps", "recall")
    lats = extra.get("latency")
    if isinstance(lats, list):
        summary["lat"] = [
            {k: p[k] for k in
             ("block_seconds", "p50_ms", "stalls", "sustained") if k in p}
            for p in lats if isinstance(p, dict)]
    else:
        _leg("lat", lats)
    out = {k: full[k] for k in ("metric", "value", "unit", "vs_baseline",
                                "card")}
    out["failed"] = failed
    out["extra"] = {"summary": summary, "full": "stderr + bench_full.json"}
    line = json.dumps(out, separators=(",", ":"))
    if len(line) > 1500:        # never outgrow a reader's tail window
        out["extra"] = {"full": "stderr + bench_full.json"}
        line = json.dumps(out, separators=(",", ":"))
    print(line)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
