#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA decoder (vdlm2dec_tpu_torch) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --phases mesh,mesh_wideband,cli_mesh,multihost
                                   # only these (of the mesh phases and of
                                   # bench_quick, wide_64, wide_76, band_760,
                                   # kchan_2000, k2_wide, stages, snr), for
                                   # work on them: prints no result line

Phases, each printed as one JSON line with the card's name and power limit:
  card       nvidia-smi name and power limit, torch and CUDA versions
  build      nvcc of vdlm2dec_tpu_torch/csrc (one process per source, in
             parallel, then one link) into a ctypes library
  deframer   g++ of csrc/hostdec.cpp into the native deframer's library,
             which must build and load here: the Python deframer the
             package may use where there is no compiler is not accepted
  capture    8 channels x 2 Msps x 10 s of impaired rtl_sdr cu8 traffic
             (stimulus.make_capture: ~9 bursts/s/channel), and 4 channels x
             6 Msps x 2 s of the same traffic as an airspy real capture.
             Every capture of the script (these two and those of the bench
             legs below) is synthesized by a process of its own, all
             started when the script starts; a phase waits for its capture
  kernel     the sync-scan kernel (K1) against its plain PyTorch version,
             both modes, on the decimated streams of every block shape the
             main path gives it: the dft route's 2 s and 4 s blocks, K2's
             32-period-aligned 2 s block (slice_pallas) and 4 s block (the
             CLI's --pallas run), the airspy slice's 6 Msps block, and
             the 64-period 6 Msps output of K2 (a stream short enough to
             take the kernel's small tiles): bit for bit equal to the
             plain version of each mode, trigger sets, and four times:
             `ms`, the kernel's own (20 launches in one CUDA graph, the
             median replay), `cold_ms`, the same with every launch on
             another copy of the input so that none is read from the L2
             cache (null for a small input), `event_ms`, one launch
             between two events with the wrapper's host work in it, and
             `plain_ms`
  kernel_k2  the fused u8 channelizer kernel (K2) against its plain
             version on capture bytes at the 2 s block of slice_pallas
             (8 ch, B = 2528 periods of 2000 samples) for both LO modes,
             at the 4 s block of the CLI's --pallas run (B = 4544), and at
             6 Msps (4 ch, 64 periods of 6000): max abs difference, the K1
             trigger sets of both outputs, the same four times, and
             `dense_route_ms`, the dense matmul route (several PyTorch
             calls: ingest, mix, torch.matmul) on the same bytes
  slice      Pipeline.stream_wideband_u8 over the whole cu8 capture for
             sync_impl stream and fused (residue-space channelizer, 2 s
             blocks, 64 trigger slots per channel, 512 decode slots, 8-row
             bursts): decoded frames must equal the stimulus truth, no slot
             overflow, and the kernel must have been launched by the run
  slice_pallas  the same with use_pallas=True: K2 then K1 on every block
  slice_xla  stream_wideband_u8 with sync_impl="xla" (K1 in stream mode,
             the flat demod on the materialized four-branch filter)
  slice_formats the capture's first 6 s as cs16 (dft channelizer) and as
             cf32 (matmul channelizer), and the airspy capture (f32real,
             6 Msps, real_input): frames equal to the truth, no overflow.
             This and the slices below (slice_bf16, slice_fir,
             slice_nonfused, live) decode the first 6 s, three blocks, of
             the 10 s capture; a burst that the cut's end cuts may decode
             or not, every other frame must equal the truth
  kernel     (again) K1 on the decimated 2 s block of the bf16 dft route,
             of the FIR route (stream_wideband's segment) and on the first
             segment of the live FIR route (160 + core + one-burst margin)
  slice_bf16 compute="bf16" on the dft and matmul routes and --pallas
  slice_fir  stream_wideband (host conversion, sample entry) with the FIR
             filter on the dense channelizer: K1 per block, no K2
  slice_nonfused  stream_wideband, boxcar, on cu8 (dft) and on cs16 with
             use_pallas (the JAX CLI's route for --pallas --format cs16,
             dense matmul, no K2)
  live       stream_live from a pipe fed by a thread: cu8 with use_pallas
             (the fused branch, K2) and the FIR filter (host conversion)
  cli        `python -m vdlm2dec_tpu_torch.cli ... -J -G -E -U` on the cu8
             capture file (plain, --pallas, --sync-impl xla, --compute
             bf16, --channel-filter fir, and --iq - with the file on
             stdin) and on the airspy file (--format f32real --fs
             6000000); every CRC-valid frame of the random-content traffic
             prints a JSON line, and the lines must equal what Pipeline +
             FrameDecoder emit in-process on the file (the CLI's own
             route: fused, or stream_wideband for FIR).  The processes of
             cli, cli_mesh and multihost start together, four CLI runs at
             a time beside the multihost jobs, after the in-process phases
             and before the bench's: nothing timed runs beside them
  cli_checkpoint  the CLI with --checkpoint stopped after two of its three
             blocks (in-process, by a KeyboardInterrupt at the third), then
             resumed as a process: the two outputs concatenate to the
             uninterrupted run's bytes
  mesh       the (chan, time) mesh, 2 x 4, its eight shards on the one card
             (spread over the cards when several are visible), on the
             decimated streams of the capture's first 4 s (each shard has
             64 decode slots, which 4 channels x 1 s of this traffic
             fit): ShardedDecoder.decode and Pipeline(mesh=...).
             decode_channels must give the frames of the unsharded
             decode_channels on the card and the truth in span, with no
             slot overflow and K1 launched once per shard
  kernel     (again) K1 on one shard's halo-extended block of that mesh
  mesh_wideband  ShardedWidebandDecoder on the same 4 s as complex samples:
             every shard channelizes its own raw planes (dense einsum),
             then the same sharded decode
  cli_mesh   the CLI with --mesh 1x1 (and 1xN on N >= 2 cards) prints the
             lines of the run without it
  multihost  parallel.multihost.launch_local: two worker processes, four
             time shards each, both on the card with their halos over gloo
             (and, on two or more cards, one card a worker over NCCL), one
             shot and windowed (--block-seconds 2 --dispatch-depth 2) over
             the whole capture: the FRAME lines of the two workers equal
             the one-process job's, none twice, and the truth
  bench_quick  the bench program (vdlm2dec_tpu_torch.bench) in-process at
             its 8-channel sizes: the primary leg (4 s blocks through
             PipelinedDecoder, three passes of six), its device leg (the
             program alone on a staged block, CUDA events, with the float32
             matmul rate, the HBM read rate and the front's share) and the
             paced latency leg at 0.25 s blocks: full recall, no overflow,
             at least three passes each, K1 once per block
  wide_64, wide_76  the bench's 64- and 76-channel legs (25 kHz spacing,
             residue-space channelizer, 1 s in one block): full recall, no
             overflow, and K1 against both plain versions on the (64, T) and
             (76, T) decimated block, bit for bit
  band_760   the bench's whole-band leg: 760 channels at 25 kHz from a
             20 Msps capture of 1 s, filterbank channelizer, streamed in
             0.5 s blocks; K1 at (760, T), T the 0.5 s block with its
             margins, bit for bit, with its times and bound, and the
             filterbank front's time on that block
  kchan_2000 the bench's 2000-channel leg (100 Msps, 0.25 s in one block)
             with bursts on channels 0 and 1999; K1 at (2000, T) bit for bit
  k2_wide    K2 against its plain version at 64 and 76 channels (2 Msps,
             the 32-period-aligned 1 s block of those legs' captures): K1's
             trigger sets on the two outputs may differ only on channels
             without traffic and only where trigger_compare.
             flip_by_suppression finds the firing decisions that differ
             within the err tolerance of the threshold on both sides; the
             line lists each such decision with its readings
  stages     stage_times.stage_table at the 8-channel 2 s block and at the
             band's block: per-stage device times with kernel counts
Each wide leg's pipeline and capture are made once, for its wall leg, its
K1 case, k2_wide and stages.
  snr        snr_sweep at 4, 8 and 20 dB x 10 trials with the golden model
             beside it: at 20 dB both decode every trial
Every wide phase prints the card's peak memory (`peak_mem_mb`).
Every phase line ends with `at_s`, the seconds since the script began.
Each decode that drives the main path starts with every kernel's launch
count at 0 and reads them when it ends; comparison launches do not count.
Every such decode must decode frames equal to the stimulus truth with no
slot overflow, launch K1 once per block and K2 once per block exactly on
the fused use_pallas routes.
Then the card line, the kernels' JSON line (each kernel's time on the
first block shape above beside its bound: the larger of its bytes over
3.35 TB/s and its float32 operations over 67 TFLOP/s, from
vdlm2dec_tpu_torch/kernel_times.py; no single PyTorch call computes
either function, so `library_ms` is null) and, last, the result line.
Any failed check raises (non-zero exit).  Without a CUDA card it exits 2
and prints no result.

It imports only the port (the stimulus included: its stimulus module),
so it runs from the repository root and nowhere else.
"""
import sys

sys.modules["jax"] = None        # the port must not need jax; fail loudly

import argparse
import concurrent.futures
import contextlib
import io
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter

import numpy as np
import torch

from vdlm2dec_tpu_torch import _build, bench, cli, snr_sweep, stimulus
from vdlm2dec_tpu_torch._tables import (HALO_LEFT, PipelineConfig,
                                        packed_stats, period_for,
                                        stream_geometry)
from vdlm2dec_tpu_torch.host import native
from vdlm2dec_tpu_torch.host.decoder import FrameDecoder
from vdlm2dec_tpu_torch.kernel_times import (card_string, cold_ms, event_ms,
                                             graph_ms, k1_bound, k2_bound)
from vdlm2dec_tpu_torch.ops import chan_u8, sync
from vdlm2dec_tpu_torch.ops.channelizer import Channelizer
from vdlm2dec_tpu_torch.ops.ingest import DC_OFFSET, raw_to_planes_split
from vdlm2dec_tpu_torch.parallel.multihost import launch_local
from vdlm2dec_tpu_torch.parallel.sharding import (ShardedDecoder,
                                                  ShardedWidebandDecoder,
                                                  burst_window, halo_exchange,
                                                  make_mesh, shard_channels)
from vdlm2dec_tpu_torch.pipeline import STAGES, Pipeline, channelize_raw
from vdlm2dec_tpu_torch.stage_times import (block_segment, slice_pipeline,
                                            stage_table)
from vdlm2dec_tpu_torch.trigger_compare import (flip_at_threshold,
                                                flip_by_suppression,
                                                trigger_set)

REPO = os.path.dirname(os.path.abspath(__file__))
FS = 2_000_000
N_CHAN = 8
SECONDS = 10.0
MAX_SYMBOLS = 5449               # 8-row bursts (MAX_BURST_SYMBOLS)
MAX_CANDIDATES = 64
MAX_OUT = 512
SLICE_BLOCK_S = 2.0
CUT_SECONDS = 6.0                # of the capture, for the later slices
PROCESSES = 4                    # CLI processes at a time
# kernel vs plain version: the same float32 operations in the same order
# (no FMA contraction in the kernel), so the two must agree bit for bit.
# The tolerance of the sync metric (trigger_compare.ERR_TOL) only says
# where a trigger may flip between two streams that differ, as K2's output
# and its plain version's do.
KERNEL_SOURCE = "vdlm2dec_tpu_torch/csrc/sync_scan.cu"
REPLACES = "vdlm2dec_tpu/ops/pallas_sync.py:82"
# K2 vs its plain version: |x lo| <= 181 and each output sums ~24-72
# products, in ascending n in the kernel and in another order in the
# dense einsum (worst case ~2.6e-4 at 2 Msps)
K2_ATOL = 1e-3
K2_SOURCE = "vdlm2dec_tpu_torch/csrc/chan_u8.cu"
K2_REPLACES = "vdlm2dec_tpu/ops/pallas_channelizer.py:33"
# of a kernel's first case, into the kernels line
KERNEL_KEYS = ("shape", "ms", "cold_ms", "event_ms", "plain_ms", "bound_ms",
               "bound_by")
AIR_FS = 6_000_000
AIR_CHAN = 4
AIR_SECONDS = 2.0
MESH_SHAPE = (2, 4)              # chan x time
MESH_SECONDS = 4.0               # 4 channels x 1 s a shard
MESH_SLOTS = 64                  # decode slots a shard (ShardedDecoder's)
MESH_PHASES = ("mesh", "mesh_wideband", "cli_mesh", "multihost")
# the bench's legs at width, and the measurement modules
BENCH_SYMBOLS = 2048             # the bench's default demod window
WIDE_PLANS = {
    "wide_64": dict(bench.SCALE_LEGS[64], max_symbols=BENCH_SYMBOLS),
    "wide_76": dict(bench.SCALE_LEGS[76], max_symbols=BENCH_SYMBOLS),
    "band_760": bench.BAND_LEG,
    "kchan_2000": bench.KCHAN_LEG,
}
WIDE_BLOCK_S = {"band_760": bench.BAND_BLOCK_S}   # streamed in blocks
WIDE_PHASES = ("bench_quick", *WIDE_PLANS, "k2_wide", "stages", "snr")
BENCH_SECONDS = 4.0              # the bench's default block
LATENCY_SECONDS = 8.0            # run_latency's default feed


def plan_capture(plan) -> dict:
    """stimulus.make_capture's arguments for a bench leg's plan, as
    bench.leg_pipeline passes them."""
    return dict(fs=plan.get("fs", FS), n_channels=plan["channels"],
                seconds=plan["seconds"], spacing=plan.get("spacing", 50_000),
                active_every=plan.get("active_every", 1),
                base=plan.get("base"),
                also_active=list(plan.get("also_active", ())))


# stimulus.make_capture's arguments for every capture the phases decode,
# the longest to make first.  Synthesis is host work of tens of seconds a
# capture, so each is made by a process of its own and all are started
# together (start_synthesis); make_capture keeps what it made on disk, and
# the phase that decodes a capture waits for its process and loads it.
CAPTURES = {
    "kchan_2000": plan_capture(WIDE_PLANS["kchan_2000"]),
    "band_760": plan_capture(WIDE_PLANS["band_760"]),
    "slice": dict(fs=FS, n_channels=N_CHAN, seconds=SECONDS),
    "bench_primary": plan_capture(dict(channels=N_CHAN,
                                       seconds=BENCH_SECONDS)),
    "bench_latency": dict(fs=FS, n_channels=N_CHAN, seconds=LATENCY_SECONDS,
                          spacing=25_000, active_every=5),   # run_latency's
    "wide_76": plan_capture(WIDE_PLANS["wide_76"]),
    "wide_64": plan_capture(WIDE_PLANS["wide_64"]),
    "air": dict(fs=AIR_FS, n_channels=AIR_CHAN, seconds=AIR_SECONDS),
}
# the phases of --phases that decode each capture
CAPTURE_PHASES = {
    "kchan_2000": ("kchan_2000",), "band_760": ("band_760", "stages"),
    "slice": (*MESH_PHASES, "stages"), "bench_primary": ("bench_quick",),
    "bench_latency": ("bench_quick",), "wide_76": ("wide_76", "k2_wide"),
    "wide_64": ("wide_64", "k2_wide"), "air": (),
}
SNR_POINTS = (4.0, 8.0, 20.0)
SNR_TRIALS = 10


T_START = time.perf_counter()
EMIT_LOCK = threading.Lock()
STDOUT = sys.stdout              # the script's own, whatever a phase redirects


def emit(phase: str, card: str, **fields) -> None:
    """One JSON line of a phase (whole, from whichever thread); at_s:
    seconds since the script began."""
    line = json.dumps({"phase": phase, "card": card, **fields,
                       "at_s": round(time.perf_counter() - T_START, 1)})
    with EMIT_LOCK:
        STDOUT.write(line + "\n")
        STDOUT.flush()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn) -> float:
    """Median of 10 CUDA-event timings of one fn() each, in ms."""
    return event_ms(fn, n=10)


def trigger_diff(err_a, fr_a, err_b, fr_b) -> tuple[int, int]:
    """(triggers in a, flipped triggers): positions valid on one side
    only.  Raises unless each flip sits where a threshold test (e1 < 4,
    e0 > e1) is within the err tolerance."""
    sets = [trigger_set(err, fr, MAX_CANDIDATES)
            for err, fr in ((err_a, fr_a), (err_b, fr_b))]
    flips = sets[0] ^ sets[1]
    e = err_a.cpu().numpy()
    for c, t in flips:
        check(flip_at_threshold(e, c, t),
              f"trigger ({c}, {t}) differs away from the threshold")
    return len(sets[0]), len(flips)


def k1_case(card, y, need_triggers=True, **fields):
    """K1 against its plain versions, both modes, on the decimated
    streams y (C, T, 2) of one block (which must hold a trigger unless
    need_triggers is false)."""
    out = {}
    for mode in sync.MODES:
        ref = sync.sync_scan_fused_ref if mode == "fused" \
            else sync.sync_scan_stream_ref
        err_k, fr_k = sync.sync_scan(y, mode)
        err_p, fr_p = ref(y)
        torch.cuda.synchronize()
        d_err = (err_k - err_p).abs()
        d_fr = (fr_k - fr_p).abs()
        n_trig, n_flip = trigger_diff(err_k, fr_k, err_p, fr_p)
        res = dict(fields, mode=mode, shape=list(y.shape),
                   err_max_abs=float(d_err.max()),
                   fr_max_abs=float(d_fr.max()),
                   bit_exact=bool(torch.equal(err_k, err_p)
                                  and torch.equal(fr_k, fr_p)),
                   triggers=n_trig, trigger_flips_near_threshold=n_flip,
                   ms=graph_ms(lambda: sync.sync_scan(y, mode)),
                   cold_ms=cold_ms(lambda v: sync.sync_scan(v, mode), y),
                   event_ms=cuda_ms(lambda: sync.sync_scan(y, mode)),
                   plain_ms=cuda_ms(lambda: ref(y)),
                   **k1_bound(y.shape[0], y.shape[1], mode))
        emit("kernel", card, **res)
        check(res["bit_exact"], f"{mode}: K1 differs from its plain version "
              f"(err by {res['err_max_abs']}, fr by {res['fr_max_abs']})")
        check((n_trig > 0 or not need_triggers) and n_flip == 0,
              f"{mode}: {n_trig} triggers, {n_flip} differ")
        out[mode] = res
    return out


def kernel_phase(card, raw, freqs, fc, block_seconds, route="dft",
                 compute="f32"):
    """K1 at the decimated shape of one block of the dft route."""
    ch = Channelizer([f - fc for f in freqs], fs=FS, device="cuda",
                     compute=compute)
    _l, _r, core_p, total_p = stream_geometry(
        ch.p_in, ch.p_out, FS, MAX_SYMBOLS, block_seconds)
    lo = core_p * ch.p_in * 2                  # block 1: traffic on both sides
    seg = torch.from_numpy(raw[lo: lo + total_p * ch.p_in * 2].copy())
    y = ch(*raw_to_planes_split(seg.cuda(), ch.p_in), split=True, period0=0)
    torch.cuda.synchronize()
    return k1_case(card, y, route=route, block_seconds=block_seconds)


def kernel_modes_phase(card, raw, reader, freqs, fc):
    """K1 on the decimated 2 s block 1 of the bf16 dft route (split-phase
    planes) and of the FIR route (stream_wideband's segment at its
    absolute period), and on the first segment of the live FIR route:
    two 2 s blocks channelized from the cursor, cut to 160 + core +
    one-burst margin."""
    offsets = [f - fc for f in freqs]
    out = [kernel_phase(card, raw, freqs, fc, SLICE_BLOCK_S,
                        route="bf16/dft", compute="bf16")]
    ch = Channelizer(offsets, fs=FS, impl="matmul", filter_mode="fir",
                     device="cuda")
    lmarg_p, rmarg_p, core_p, _t = stream_geometry(
        ch.p_in, ch.p_out, FS, MAX_SYMBOLS, SLICE_BLOCK_S)
    lo_p = core_p - lmarg_p                    # block 1
    y = ch.channelize(reader.read(lo_p * ch.p_in,
                                  (lmarg_p + core_p + rmarg_p) * ch.p_in),
                      period0=lo_p)
    torch.cuda.synchronize()
    out.append(k1_case(card, y, route="fir", block_seconds=SLICE_BLOCK_S))
    rpb = core_p * ch.p_in
    span = HALO_LEFT + core_p * ch.p_out + 24 + 8 * MAX_SYMBOLS
    x = reader.read(0, 2 * rpb)
    y = torch.cat([ch.channelize(x[:rpb], period0=0),
                   ch.channelize(x[rpb:], period0=core_p)], dim=1)
    torch.cuda.synchronize()
    out.append(k1_case(card, y[:, :span].contiguous(), route="live/fir",
                       block_seconds=SLICE_BLOCK_S))
    return out


def kernel_air_phase(card, real, air_freqs, air_fc):
    """K1 on the airspy slice's block 0 (f32real at 6 Msps, its left
    margin padded as the stream pads it), channelized by the slice's own
    channelizer."""
    ch = Pipeline(air_config(air_freqs, air_fc), device="cuda").channelizer
    lmarg_p, _r, _c, total_p = stream_geometry(
        ch.p_in, ch.p_out, AIR_FS, MAX_SYMBOLS, SLICE_BLOCK_S)
    seg = np.zeros(total_p * ch.p_in, np.float32)
    n = min(len(real), (total_p - lmarg_p) * ch.p_in)
    seg[lmarg_p * ch.p_in: lmarg_p * ch.p_in + n] = real[:n]
    y = channelize_raw(torch.from_numpy(seg).cuda(), ch, "f32real", False)
    torch.cuda.synchronize()
    return k1_case(card, y, route=f"f32real/{ch.impl}", fs=AIR_FS,
                   block_seconds=SLICE_BLOCK_S)


def main_path_launches() -> dict:
    """Every kernel's launch count, by the kernels line's names."""
    out = {f"sync_scan[{m}]": sync.launches[m] for m in sync.MODES}
    out["chan_u8"] = chan_u8.launches
    return out


def reset_launches() -> None:
    sync.reset_launches()
    chan_u8.reset_launches()


def k2_case(card, raw, offsets, fs, lo_wrap, b, period0, with_triggers,
            **fields):
    """K2 against its plain version on one block of b periods of cu8
    bytes that starts at absolute period period0: (result, K2's y, the
    plain version's y).  with_triggers: K1's trigger sets on both outputs
    must be equal."""
    ch = Channelizer(offsets, fs=fs, lo_wrap=lo_wrap, impl="matmul",
                     device="cuda")
    seg = torch.from_numpy(np.ascontiguousarray(raw)).cuda()
    ph_r, ph_i = ch.phases(b, period0)
    args = (seg, ch.lo_r, ch.lo_i, ph_r, ph_i, ch.a, DC_OFFSET)
    y_k = chan_u8.channelize_u8(*args)
    y_p = chan_u8.channelize_u8_ref(*args)
    torch.cuda.synchronize()
    n_chan = len(offsets)
    check(y_k.shape == y_p.shape == (n_chan, b, ch.p_out, 2),
          f"K2 output shape {tuple(y_k.shape)}")
    err = float((y_k - y_p).abs().max())
    check(bool(torch.isfinite(y_k).all()), "K2 output not finite")
    check(err <= K2_ATOL, f"K2 differs by {err} > {K2_ATOL}")
    res = dict(fields, shape=[n_chan, b, ch.p_in], fs=fs, lo_wrap=lo_wrap,
               max_abs_err=err,
               max_abs=float(y_p.abs().max()),
               ms=graph_ms(lambda: chan_u8.channelize_u8(*args)),
               cold_ms=cold_ms(
                   lambda v: chan_u8.channelize_u8(v, *args[1:]), seg),
               event_ms=cuda_ms(lambda: chan_u8.channelize_u8(*args)),
               plain_ms=cuda_ms(lambda: chan_u8.channelize_u8_ref(*args)),
               dense_route_ms=cuda_ms(
                   lambda: channelize_raw(seg, ch, "cu8", False)),
               **k2_bound(n_chan, b, ch.p_in, ch.p_out))
    if with_triggers:
        ys = [y.reshape(n_chan, -1, 2) for y in (y_k, y_p)]
        (err_k, fr_k), (err_p, fr_p) = (sync.sync_scan(y) for y in ys)
        n_trig, n_flip = trigger_diff(err_k, fr_k, err_p, fr_p)
        check(n_trig > 0 and n_flip == 0, f"K2: {n_trig} triggers, "
              f"{n_flip} differ between its output and its plain version's")
        res.update(triggers=n_trig, trigger_flips_near_threshold=n_flip)
    emit("kernel_k2", card, **res)
    return res, y_k, y_p


def kernel_k2_phase(card, raw, freqs, fc, air_u8, air_offsets):
    """K2 on block 1 of the 32-period-aligned streams that reach it: the
    slice's 2 s blocks (both LO modes) and the CLI's --pallas blocks
    (4 s by default), with K1 on K2's output; then 64 periods of the
    6 Msps traffic as cu8.  Returns (K2 results, K1 results)."""
    p_in, p_out = period_for(FS // 4000)
    offsets = [f - fc for f in freqs]
    args = cli.build_parser().parse_args(
        ["136.5", "--iq", "cap.cu8", "--fc", str(fc), "--pallas"])
    cli_cfg = cli.pipeline_config(args, [136_500_000])
    cases = [(SLICE_BLOCK_S, MAX_SYMBOLS, True),
             (SLICE_BLOCK_S, MAX_SYMBOLS, False),
             (args.block_seconds, cli_cfg.max_symbols, True)]
    k2, k1 = [], []
    for block_s, max_symbols, wrap in cases:
        lmarg_p, _r, core_p, total_p = stream_geometry(
            p_in, p_out, FS, max_symbols, block_s, align=32)
        lo = (core_p - lmarg_p) * p_in * 2     # block 1
        res, y, _y_p = k2_case(card, raw[lo: lo + total_p * p_in * 2],
                               offsets, FS, wrap, total_p, core_p - lmarg_p,
                               True, block_seconds=block_s)
        k2.append(res)
        if wrap:
            k1.append(k1_case(card, y.reshape(len(offsets), -1, 2),
                              route="pallas", block_seconds=block_s))
    air_p_in = 4 * (AIR_FS // 4000)
    lo = len(air_u8) // (4 * air_p_in) * 2 * air_p_in      # mid-capture
    res, y, _y_p = k2_case(card, air_u8[lo: lo + 64 * air_p_in * 2],
                           air_offsets, AIR_FS, True, 64,
                           lo // (2 * air_p_in), False)
    k2.append(res)
    # a stream this short takes K1's 256-position tiles, the others 1024
    k1.append(k1_case(card, y.reshape(len(air_offsets), -1, 2),
                      need_triggers=False, route="pallas/short", fs=AIR_FS))
    return k2, k1


def slice_config(freqs, fc, sync_impl, **kw) -> PipelineConfig:
    return PipelineConfig(
        freqs_hz=[float(f) for f in freqs], fs=kw.pop("fs", FS),
        fc_hz=float(fc), max_candidates=MAX_CANDIDATES,
        max_symbols=MAX_SYMBOLS, max_out=MAX_OUT, sync_impl=sync_impl, **kw)


def air_config(air_freqs, air_fc) -> PipelineConfig:
    """The airspy slice: F0 = fc + fs/4 is the capture's center, where
    make_capture's offsets are all positive, so each conjugate image
    misses every channel."""
    return slice_config(air_freqs, air_fc - AIR_FS // 4, "stream",
                        fs=AIR_FS, real_input=True)


def truth_in_span(truth, n_samples, fs):
    """The stimulus bursts inside the decoded span, as a frame Counter."""
    return span_truth(truth, n_samples, fs)[0]


def span_truth(truth, n_samples, fs):
    """(the stimulus bursts inside the capture's first n_samples, those
    that its end cuts), as frame Counters.  A cut burst is not asked for,
    but may decode where the code corrects what is missing."""
    p_in, p_out = period_for(fs // 4000)
    span84 = (n_samples // p_in) * p_out
    return (Counter((c, b) for c, b, p0, n in truth if p0 + n <= span84),
            Counter((c, b) for c, b, p0, n in truth if p0 < span84 < p0 + n))


def decode_phase(card, phase, pipe, raw, fmt, n_samples, truth, **fields):
    """One counted main-path decode of a whole capture through
    stream_wideband_u8 (counted_decode)."""
    per = len(raw) // n_samples

    def stream(n):
        return pipe.stream_wideband_u8(raw if n is None else raw[: per * n],
                                       block_seconds=SLICE_BLOCK_S, fmt=fmt)

    return counted_decode(card, phase, pipe, stream, n_samples, truth,
                          k2=pipe.cfg.use_pallas, file_blocks=True, fmt=fmt,
                          **fields)


def counted_decode(card, phase, pipe, stream, n_samples, truth, k2,
                   file_blocks, **fields):
    """One counted main-path decode: stream(n) yields the burst lists of
    the decode of the capture's first n samples (None: all of it).  The
    frames must equal the truth (a burst that the end of a cut capture
    cuts may come besides), with no slot overflow; K1 (in the mode
    the route runs) must be launched once per decoded block, K2 once per
    block if k2 and never otherwise, and with file_blocks the blocks are
    the capture's core blocks."""
    want, edge = span_truth(truth, n_samples, pipe.cfg.fs)
    for _ in stream(pipe.core_raw_samples(SLICE_BLOCK_S)):
        pass                                   # builds tables, warms up
    torch.cuda.synchronize()
    pipe.metrics = cli.PipelineMetrics()
    pipe._overflow_warned = False
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                           # counts of the main path
    t = time.perf_counter()
    blocks = list(stream(None))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = main_path_launches()
    got = Counter((b.channel, bytes(bytearray(f[1:-3])))
                  for bs in blocks for b in bs for f in b.frames)
    m = pipe.metrics
    n_blocks = len(blocks)
    cfg = pipe.cfg
    res = dict(fields, chan_impl=cfg.chan_impl, use_pallas=cfg.use_pallas,
               sync_impl=cfg.sync_impl, compute=cfg.compute,
               filter_mode=cfg.filter_mode, fs=cfg.fs,
               channels=len(cfg.freqs_hz), blocks=n_blocks,
               frames=sum(got.values()), truth_bursts=sum(want.values()),
               recall=f"{sum((got & want).values())}/{sum(want.values())}",
               missed=sum((want - got).values()),
               extra=sum((got - want).values()), cut_by_end=sum(edge.values()),
               sync_candidates=m.sync_candidates,
               candidates_overflow=m.candidates_overflow,
               launches=launched, wall_s=wall,
               msps=n_samples / wall / 1e6,
               peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    emit(phase, card, **res)
    what = f"{phase} {fields}"
    check(not want - got and not (got - want) - edge,
          f"{what}: decoded frames differ from the truth")
    check(m.candidates_overflow == 0, f"{what}: decode slots overflowed")
    if file_blocks:
        want_blocks = -(-n_samples // pipe.core_raw_samples(SLICE_BLOCK_S))
        check(n_blocks == want_blocks,
              f"{what}: {n_blocks} blocks, want {want_blocks}")
    check(n_blocks > 0, f"{what}: no block decoded")
    expect = {k: 0 for k in launched}
    # "xla" takes its sync metric from K1's stream mode
    k1 = "stream" if cfg.sync_impl == "xla" else cfg.sync_impl
    expect[f"sync_scan[{k1}]"] = n_blocks
    if k2:
        expect["chan_u8"] = n_blocks
    check(launched == expect,
          f"{what}: launches {launched}, want {expect} for {n_blocks} blocks")
    return launched


def reader_stream(pipe, reader):
    """stream(n) of stream_wideband over a CaptureReader: the host
    converts each segment, and the channelizer's sample entry takes it
    (the JAX CLI's route for the FIR filter and --pallas on non-cu8)."""
    def stream(n):
        x = reader if n is None else reader.read(0, n)
        return pipe.stream_wideband(x, block_seconds=SLICE_BLOCK_S)
    return stream


def slice_xla_phase(card, raw, freqs, fc, truth):
    """sync_impl="xla" on the default (dft) route."""
    pipe = Pipeline(slice_config(freqs, fc, "xla"), device="cuda")
    return decode_phase(card, "slice_xla", pipe, raw, "cu8", len(raw) // 2,
                        truth, route="xla")


def slice_bf16_phase(card, raw, freqs, fc, truth):
    """compute="bf16" on the dft and matmul routes and under use_pallas
    (where K2 ignores compute, as the JAX package's Pallas path)."""
    launches = Counter()
    for route, kw in (("dft", dict(chan_impl="dft")),
                      ("matmul", dict(chan_impl="matmul")),
                      ("pallas", dict(use_pallas=True))):
        pipe = Pipeline(slice_config(freqs, fc, "stream", compute="bf16",
                                     **kw), device="cuda")
        launches.update(decode_phase(card, "slice_bf16", pipe, raw, "cu8",
                                     len(raw) // 2, truth,
                                     route=f"bf16/{route}"))
    return launches


def slice_fir_phase(card, reader, freqs, fc, truth):
    """The FIR filter through stream_wideband (dense matmul, no K2)."""
    pipe = Pipeline(slice_config(freqs, fc, "stream", filter_mode="fir"),
                    device="cuda")
    check(pipe.cfg.chan_impl == "matmul", "fir resolved to "
          f"{pipe.cfg.chan_impl}")
    return counted_decode(card, "slice_fir", pipe, reader_stream(pipe, reader),
                          len(reader), truth, k2=False, file_blocks=True,
                          fmt="cu8", route="fir")


def slice_nonfused_phase(card, readers, freqs, fc, truth):
    """stream_wideband with the boxcar filter: cu8 on the dft route, and
    cs16 with use_pallas, which the JAX CLI sends to stream_wideband (the
    fused u8 channelizer takes cu8 only): dense matmul, no K2."""
    launches = Counter()
    for fmt, kw in (("cu8", dict()), ("cs16", dict(use_pallas=True))):
        pipe = Pipeline(slice_config(freqs, fc, "stream", **kw),
                        device="cuda")
        launches.update(counted_decode(
            card, "slice_nonfused", pipe, reader_stream(pipe, readers[fmt]),
            len(readers[fmt]), truth, k2=False, file_blocks=True, fmt=fmt,
            route=f"stream_wideband/{fmt}"))
    return launches


def pipe_reader(path):
    """The read end of a pipe that a thread fills with the file's bytes
    (an rtl_sdr | decoder stand-in), and the thread."""
    r, w = os.pipe()

    def feed():
        with open(path, "rb") as src, os.fdopen(w, "wb") as dst:
            shutil.copyfileobj(src, dst, 1 << 20)

    th = threading.Thread(target=feed, daemon=True)
    th.start()
    return os.fdopen(r, "rb"), th


def live_phase(card, path, freqs, fc, truth):
    """stream_live from a pipe: the fused branch (cu8, use_pallas: K2 and
    K1 per block) and the host-conversion branch (FIR: K1 per decoded
    segment of the rolling window)."""
    launches = Counter()
    n_samples = os.path.getsize(path) // 2
    for route, kw in (("fused/pallas", dict(use_pallas=True)),
                      ("fir", dict(filter_mode="fir"))):
        pipe = Pipeline(slice_config(freqs, fc, "stream", **kw),
                        device="cuda")
        readers = []

        def stream(n):
            if n is not None:
                with open(path, "rb") as fh:
                    src = io.BytesIO(fh.read(2 * n))
            else:
                src, th = pipe_reader(path)
                readers.append((src, th))
            return pipe.stream_live(src, block_seconds=SLICE_BLOCK_S)

        try:
            launches.update(counted_decode(
                card, "live", pipe, stream, n_samples, truth,
                k2=pipe.cfg.use_pallas, file_blocks=False, fmt="cu8",
                route=route))
        finally:
            for src, th in readers:
                th.join(timeout=60)
                src.close()
    return launches


def slice_pallas_phase(card, raw, freqs, fc, truth):
    """The cu8 slice with use_pallas: the fused u8 channelizer (K2)."""
    pipe = Pipeline(slice_config(freqs, fc, "stream", use_pallas=True),
                    device="cuda")
    check(pipe.cfg.chan_impl == "matmul", "use_pallas resolved to "
          f"{pipe.cfg.chan_impl}")
    return decode_phase(card, "slice_pallas", pipe, raw, "cu8",
                        len(raw) // 2, truth, route="pallas")


def format_captures(wide, air_wide):
    """The slice's traffic as cs16 (round(wide * 256), as
    tools/drive_formats.py) and cf32, and the 6 Msps traffic as an airspy
    real capture 2 Re{wide}."""
    inter = np.empty(2 * len(wide), np.float32)
    inter[0::2], inter[1::2] = wide.real, wide.imag
    cs16 = np.clip(np.round(inter * 256), -32768, 32767).astype(np.int16)
    return cs16, inter, (2.0 * air_wide.real).astype(np.float32)


def slice_formats_phase(card, caps, freqs, fc, truth, air):
    """cs16 (dft), cf32 (matmul) and f32real (airspy, 6 Msps)."""
    cs16, cf32, real = caps
    air_freqs, air_fc, air_truth = air
    runs = [
        ("cs16", cs16, Pipeline(slice_config(freqs, fc, "stream"),
                                device="cuda"), truth),
        ("cf32", cf32, Pipeline(slice_config(freqs, fc, "stream",
                                             chan_impl="matmul"),
                                device="cuda"), truth),
        ("f32real", real, Pipeline(air_config(air_freqs, air_fc),
                                   device="cuda"), air_truth),
    ]
    out = {}
    for fmt, raw, pipe, want in runs:
        n = len(raw) if fmt == "f32real" else len(raw) // 2
        out[fmt] = decode_phase(card, "slice_formats", pipe, raw, fmt, n,
                                want, route=fmt)
    return out


def slice_phase(card, raw, freqs, fc, truth):
    """The decode slice through Pipeline.stream_wideband_u8, both modes."""
    launches = Counter()
    for mode in sync.MODES:
        pipe = Pipeline(slice_config(freqs, fc, mode), device="cuda")
        launches.update(decode_phase(card, "slice", pipe, raw, "cu8",
                                     len(raw) // 2, truth, sync_impl=mode))
    return launches


def cli_argv(path, freqs, fc, extra=()):
    return [*(f"{f / 1e6:.6f}" for f in freqs), "--iq", path,
            "--fc", str(fc), "-J", "-G", "-E", "-U", "--start-time", "0",
            "-i", "SMOKE", *extra]


def run_cli(argv, stdin_path=None):
    """The CLI as a process: (stdout, wall seconds); raises unless it
    exits 0."""
    t = time.perf_counter()
    with open(stdin_path or os.devnull, "rb") as stdin:
        r = subprocess.run([sys.executable, "-m", "vdlm2dec_tpu_torch.cli",
                            *argv], stdin=stdin, capture_output=True,
                           text=True, timeout=900, cwd=REPO)
    wall = time.perf_counter() - t
    check(r.returncode == 0, f"cli exited {r.returncode}: {r.stderr[-2000:]}")
    return r.stdout, wall


def cli_process(path, freqs, fc, extra=(), stdin=False):
    """run_cli's arguments for cli_phase's CLI process."""
    return (cli_argv("-" if stdin else path, freqs, fc, extra),
            path if stdin else None)


def start_cli(pool, *args, **kw):
    """cli_phase's CLI process (cli_process's arguments), started on a
    thread of the pool."""
    return pool.submit(run_cli, *cli_process(*args, **kw))


def cli_phase(card, path, fmt, freqs, fc, extra=(), stdin=False,
              started=None) -> str:
    """The CLI on a capture file (or, with stdin, on `--iq -` with the
    file on its stdin) vs the decode of the file in-process through the
    CLI's own route.  started: its process, from start_cli with the same
    arguments (else it is run here).  Returns the CLI's stdout."""
    argv = cli_argv(path, freqs, fc, extra)
    out, wall = started.result() if started \
        else run_cli(*cli_process(path, freqs, fc, extra, stdin))
    got = [ln for ln in out.splitlines() if ln.strip()]

    args = cli.build_parser().parse_args(argv)
    check(args.format == fmt, f"cli format {args.format} != {fmt}")
    cfg = cli.pipeline_config(
        args, cli.validate_freqs([int(f * 1e6) for f in args.freqs]),
        cli.mesh_from_flag(args))
    log = io.StringIO()
    dec = FrameDecoder(cli.output_config(args, log), time_base=0.0)
    pipe = Pipeline(cfg, device="cuda")
    reader = cli.CaptureReader(path, fmt)
    fused = pipe.fused_route(fmt) and cfg.mesh is None
    if fused:
        stream = pipe.stream_wideband_u8(
            reader.raw, block_seconds=args.block_seconds, fmt=fmt)
    else:
        stream = pipe.stream_wideband(reader,
                                      block_seconds=args.block_seconds)
    for bursts in stream:
        for b in bursts:
            dec.process_burst(b)
    want = [ln for ln in log.getvalue().splitlines() if ln.strip()]
    emit("cli", card, format=fmt, flags=list(extra), stdin=stdin,
         lines=len(got), lines_in_process=len(want), identical=got == want,
         wall_s=wall, block_seconds=args.block_seconds,
         max_symbols=cfg.max_symbols, max_out=pipe._max_out(),
         chan_impl=pipe.cfg.chan_impl, fused=fused)
    check(len(got) > 0, "the CLI printed no JSON line")
    check(got == want, f"CLI JSON lines {extra} differ from the in-process "
          "decode")
    return out


def cli_checkpoint_phase(card, path, freqs, fc, full: str):
    """--checkpoint: the CLI's main() stopped after two of the three 4 s
    blocks (a KeyboardInterrupt at the third block's metrics, as SIGINT
    would land; in-process so that the stop is exact), then the CLI
    process resumed from the checkpoint.  full: the uninterrupted run's
    stdout, which the two outputs must concatenate to, byte for byte."""
    with tempfile.TemporaryDirectory(prefix="vdl2_ckpt_") as tmp:
        argv = cli_argv(path, freqs, fc,
                        ["--checkpoint", os.path.join(tmp, "state.ckpt")])
        orig = cli.PipelineMetrics.observe_bursts
        seen = [0]

        def stop_at_third(self, bursts):
            if seen[0] == 2:
                raise KeyboardInterrupt
            seen[0] += 1
            return orig(self, bursts)

        part1 = io.StringIO()
        cli.PipelineMetrics.observe_bursts = stop_at_third
        try:
            with contextlib.redirect_stdout(part1):
                rc = cli.main(argv)
        finally:
            cli.PipelineMetrics.observe_bursts = orig
        check(rc == 0, f"interrupted CLI run exited {rc}")
        with open(os.path.join(tmp, "state.ckpt")) as fh:
            cursor = json.load(fh)["sample_cursor"]
        part2, wall = run_cli(argv)
    n = [len([ln for ln in p.splitlines() if ln.strip()])
         for p in (part1.getvalue(), part2, full)]
    emit("cli_checkpoint", card, cursor=cursor, lines=n,
         identical=part1.getvalue() + part2 == full, wall_s=wall)
    check(cursor == 2 * 4 * FS, f"checkpoint cursor {cursor}")
    check(n[0] > 0 and n[1] > 0, "a part of the resumed run printed nothing")
    check(part1.getvalue() + part2 == full,
          "stopped + resumed CLI output differs from the uninterrupted run")


def frame_counter(bursts) -> Counter:
    return Counter((b.channel, bytes(bytearray(f[1:-3])))
                   for b in bursts for f in b.frames)


def shard_devices(n: int) -> list:
    """n shards over the visible cards, round robin: all on the one card
    when only one is visible."""
    cards = torch.cuda.device_count()
    return [f"cuda:{i % cards}" for i in range(n)]


def mesh_span(p_in: int) -> int:
    """Raw samples of the mesh phases' cut: whole periods for every time
    shard."""
    step = MESH_SHAPE[1] * p_in
    return int(MESH_SECONDS * FS) // step * step


def counted_mesh_decode(card, phase, decode, want, **fields):
    """One counted decode over the mesh: decode() -> (bursts, packed
    stats).  The frames must equal want with no slot overflow, and K1
    (stream mode: the shard body's sync "xla") must have been launched
    once per shard, K2 never."""
    n_shards = MESH_SHAPE[0] * MESH_SHAPE[1]
    decode()                                   # warms up
    torch.cuda.synchronize()
    reset_launches()                           # counts of the main path
    t = time.perf_counter()
    bursts, stats = decode()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = main_path_launches()
    got = frame_counter(bursts)
    emit(phase, card, **fields, mesh="x".join(map(str, MESH_SHAPE)),
         devices=sorted(set(shard_devices(n_shards))), seconds=MESH_SECONDS,
         slots_per_shard=MESH_SLOTS, frames=sum(got.values()),
         truth_bursts=sum(want.values()), missed=sum((want - got).values()),
         extra=sum((got - want).values()), **stats, launches=launched,
         wall_s=wall)
    what = f"{phase} {fields}"
    check(got == want, f"{what}: decoded frames differ from the truth")
    check(stats["candidates_overflow"] == 0, f"{what}: decode slots "
          "overflowed")
    expect = dict.fromkeys(launched, 0)
    expect["sync_scan[stream]"] = n_shards
    check(launched == expect, f"{what}: launches {launched}, want {expect}")
    return launched


def mesh_phase(card, raw, freqs, fc, truth):
    """ShardedDecoder and Pipeline(mesh=...).decode_channels on the
    decimated streams of the capture's first MESH_SECONDS, against the
    unsharded decode_channels on the card and the truth; then K1 on one
    shard's halo-extended block.  Returns (launches, K1 case)."""
    n_chan, n_time = MESH_SHAPE
    mesh = make_mesh(n_chan, n_time, devices=shard_devices(n_chan * n_time))
    ch = Channelizer([f - fc for f in freqs], fs=FS, device="cuda")
    n = mesh_span(ch.p_in)
    seg = torch.from_numpy(raw[: 2 * n].copy()).cuda()
    y = ch(*raw_to_planes_split(seg, ch.p_in), split=True, period0=0)
    want = truth_in_span(truth, n, FS)
    plain = Pipeline(slice_config(freqs, fc, "xla"), device="cuda")
    unsharded = frame_counter(plain.decode_channels(y))
    check(unsharded == want and sum(want.values()) > 0,
          "mesh: the unsharded decode of the cut differs from the truth")

    dec = ShardedDecoder(mesh, max_candidates=MAX_CANDIDATES,
                         max_symbols=MAX_SYMBOLS, max_out=MESH_SLOTS)

    def direct():
        bufs = []
        cands = dec.decode(y, observer=bufs.append)
        return plain._finish(cands, 0), packed_stats(bufs[0])

    pipe = Pipeline(slice_config(freqs, fc, "stream", mesh=mesh),
                    device="cuda")

    def through_pipeline():
        pipe.metrics = cli.PipelineMetrics()
        pipe._overflow_warned = False
        bursts = pipe.decode_channels(y)
        m = pipe.metrics
        return bursts, dict(sync_candidates=m.sync_candidates,
                            bursts_rejected_header=m.bursts_rejected_header,
                            candidates_overflow=m.candidates_overflow)

    launches = Counter()
    launches.update(counted_mesh_decode(card, "mesh", direct, want,
                                        entry="ShardedDecoder.decode"))
    launches.update(counted_mesh_decode(
        card, "mesh", through_pipeline, want,
        entry="Pipeline(mesh).decode_channels"))
    # K1 at the shape a shard gives it: left halo + core + one burst window
    y_ext = halo_exchange(shard_channels(mesh, y)[0], HALO_LEFT,
                          burst_window(MAX_SYMBOLS))[1]
    k1 = k1_case(card, y_ext.to("cuda:0").contiguous(), route="mesh/shard",
                 block_seconds=MESH_SECONDS / n_time)
    return launches, k1


def mesh_wideband_phase(card, wide, freqs, fc, truth):
    """ShardedWidebandDecoder from the raw samples of the same cut."""
    n_chan, n_time = MESH_SHAPE
    mesh = make_mesh(n_chan, n_time, devices=shard_devices(n_chan * n_time))
    sdrclk = FS // 4000
    n = mesh_span(period_for(sdrclk)[0])
    x = wide[:n].astype(np.complex64)
    dec = ShardedWidebandDecoder(
        mesh, f_offsets=tuple(f - fc for f in freqs), fs=FS, sdrclk=sdrclk,
        max_candidates=MAX_CANDIDATES, max_symbols=MAX_SYMBOLS,
        max_out=MESH_SLOTS)
    plain = Pipeline(slice_config(freqs, fc, "xla"), device="cuda")

    def decode():
        bufs = []
        cands = dec.decode(x, observer=bufs.append)
        return plain._finish(cands, 0), packed_stats(bufs[0])

    return counted_mesh_decode(card, "mesh_wideband", decode,
                               truth_in_span(truth, n, FS),
                               entry="ShardedWidebandDecoder.decode")


def mesh_shapes() -> list[str]:
    shapes = ["1x1"]
    if torch.cuda.device_count() >= 2:
        shapes.append(f"1x{torch.cuda.device_count()}")
    return shapes


def cli_mesh_phase(card, path, freqs, fc, full: str, started=None):
    """--mesh CxT builds its mesh from the visible cards and streams
    through the host-converted route: the same lines as without it.
    started: shape -> its process from start_cli."""
    for shape in mesh_shapes():
        out = cli_phase(card, path, "cu8", freqs, fc, ["--mesh", shape],
                        started=started and started[shape])
        check(out == full, f"--mesh {shape} printed other lines than the "
              "run without it")


def frame_lines(outs) -> Counter:
    return Counter(ln for out in outs for ln in out.splitlines()
                   if ln.startswith("FRAME "))


def multihost_phase(card, path, freqs, fc, truth, n_samples):
    """launch_local(2, ...): two workers x four time shards on the card,
    halos over gloo (and over NCCL with a card a worker when two are
    visible), one shot and windowed, against the one-process job of the
    same mode and the truth."""
    base = [*(f"{f / 1e6:.6f}" for f in freqs), "--iq", path, "--fc", str(fc),
            "--time-shards", "8", "--max-symbols", str(MAX_SYMBOLS),
            "--max-candidates", str(MAX_CANDIDATES), "--max-out", str(MAX_OUT)]
    modes = {"oneshot": [],
             "windowed": ["--block-seconds", str(SLICE_BLOCK_S),
                          "--dispatch-depth", "2", "--timing"]}
    jobs = [("gloo", ["cuda:0", "cuda:0"])]
    if torch.cuda.device_count() >= 2:
        jobs.append(("nccl", ["cuda:0", "cuda:1"]))
    want = truth_in_span(truth, n_samples, FS)
    for mode, extra in modes.items():
        t = time.perf_counter()
        single = frame_lines(launch_local(1, base + extra, local_devices=8,
                                          device="cuda:0", timeout=600))
        emit("multihost", card, mode=mode, processes=1, backend=None,
             frame_lines=sum(single.values()), wall_s=time.perf_counter() - t)
        for backend, devices in jobs:
            t = time.perf_counter()
            outs = launch_local(2, base + extra, local_devices=4,
                                device=devices, backend=backend, timeout=600)
            wall = time.perf_counter() - t
            lines = frame_lines(outs)
            got = Counter()
            for ln in lines.elements():
                _tag, chan, _t0, hexed = ln.split()
                got[int(chan), bytes.fromhex(hexed)[1:-3]] += 1
            stats = [json.loads(ln[6:]) for out in outs
                     for ln in out.splitlines() if ln.startswith("STATS ")]
            emit("multihost", card, mode=mode, processes=2, backend=backend,
                 devices=devices, frame_lines=sum(lines.values()),
                 per_process=[sum(frame_lines([o]).values()) for o in outs],
                 truth_bursts=sum(want.values()),
                 missed=sum((want - got).values()),
                 extra=sum((got - want).values()),
                 equals_one_process=lines == single, stats=stats, wall_s=wall)
            what = f"multihost {mode} over {backend}"
            check(max(lines.values(), default=0) == 1,
                  f"{what}: a FRAME line came out twice")
            check(lines == single, f"{what}: the two workers' FRAME lines "
                  "differ from the one-process job's")
            check(got == want, f"{what}: decoded frames differ from the truth")
            check(all(o.splitlines()[-1].startswith(f"DONE {i} ")
                      for i, o in enumerate(outs)), f"{what}: a worker did "
                  "not finish")


def processes_phase(card, path, air_path, freqs, fc, air_freqs, air_fc, truth,
                    n_samples):
    """The phases that run the port as processes: cli, cli_checkpoint,
    cli_mesh and multihost.  A process takes ten seconds and more to start
    and reach the card, so the CLI runs are started together, PROCESSES at
    a time, beside the multihost jobs (one after another on a thread of
    their own), and each is then held to its in-process decode as before.
    Nothing that is timed runs meanwhile."""
    air = (air_path, air_freqs, air_fc - AIR_FS // 4,
           ["--format", "f32real", "--fs", str(AIR_FS)])
    flag_sets = ([], ["--pallas"], ["--sync-impl", "xla"],
                 ["--compute", "bf16"], ["--channel-filter", "fir"])
    with concurrent.futures.ThreadPoolExecutor(PROCESSES + 1) as pool:
        multihost = pool.submit(multihost_phase, card, path, freqs, fc, truth,
                                n_samples)
        runs = [start_cli(pool, path, freqs, fc, extra)
                for extra in flag_sets]
        air_run = start_cli(pool, *air)
        stdin_run = start_cli(pool, path, freqs, fc, stdin=True)
        mesh_runs = {shape: start_cli(pool, path, freqs, fc,
                                      ["--mesh", shape])
                     for shape in mesh_shapes()}
        full = cli_phase(card, path, "cu8", freqs, fc, started=runs[0])
        cli_phase(card, path, "cu8", freqs, fc, ["--pallas"],
                  started=runs[1])
        cli_phase(card, air[0], "f32real", *air[1:], started=air_run)
        for extra, started in zip(flag_sets[2:], runs[2:]):
            cli_phase(card, path, "cu8", freqs, fc, extra, started=started)
        live_out = cli_phase(card, path, "cu8", freqs, fc, stdin=True,
                             started=stdin_run)
        check(live_out == full, "--iq - printed other lines than the file")
        cli_checkpoint_phase(card, path, freqs, fc, full)
        cli_mesh_phase(card, path, freqs, fc, full, mesh_runs)
        multihost.result()


def counted_bench_leg(card, phase, leg, run, blocks_per_decode, decodes,
                      **fields):
    """One leg of the bench program, counted: run() -> the leg's record.
    K1 (stream mode) must have been launched once per block, K2 never."""
    reset_launches()                           # counts of the main path
    out = run()
    launched = main_path_launches()
    out.pop("card", None)
    emit(phase, card, leg=leg, **fields, **out, launches=launched)
    expect = dict.fromkeys(launched, 0)
    expect["sync_scan[stream]"] = blocks_per_decode * decodes
    check(launched == expect,
          f"{phase}/{leg}: launches {launched}, want {expect}")
    return out, launched


def check_wall_leg(what, out):
    n, of = out["recall"].split("/")
    check(n == of and int(of) > 0, f"{what}: recall {out['recall']}")
    check(out["candidates_overflow"] == 0, f"{what}: decode slots overflowed")
    check(len(out["msps_passes"]) >= 3,
          f"{what}: {len(out['msps_passes'])} passes")
    check(out["duplicates"] == out["leakage"] == out["spurious"] == 0,
          f"{what}: frames beyond the truth: {out}")


def bench_quick_phase(card, synth):
    """The bench program's 8-channel legs at its default sizes: primary,
    device leg, latency at 0.25 s blocks."""
    launches = Counter()
    iters = 6
    sizes = (N_CHAN, BENCH_SECONDS, iters, BENCH_SYMBOLS, None, False)
    route = dict(device="cuda", chan_impl="auto", sync_impl="stream")
    await_capture(synth, "bench_primary")
    out, counted = counted_bench_leg(
        card, "bench_quick", "primary",
        lambda: bench.run_config(*sizes, **route), 1, 1 + bench.PASSES * iters)
    check_wall_leg("bench_quick/primary", out)
    launches.update(counted)
    outer, inner = 3, 4
    dev, counted = counted_bench_leg(
        card, "bench_quick", "device_8ch",
        lambda: bench.run_device_config(N_CHAN, BENCH_SECONDS, outer, inner,
                                        BENCH_SYMBOLS, None, False, **route),
        1, 1 + outer * inner)
    launches.update(counted)
    check(len(dev["device_msps_passes"]) >= 3
          and dev["candidates_overflow"] == 0
          and dev["blocks_timed"] == outer * inner,
          f"bench_quick/device_8ch: {dev}")
    check(0 < dev["channelizer_share_of_matmul_peak"] < 1
          and dev["matmul_peak_gflops_f32"] > 0 and dev["hbm_read_gbps"] > 0,
          f"bench_quick/device_8ch: roofline probes {dev}")
    await_capture(synth, "bench_latency")
    lat_blocks = int(LATENCY_SECONDS / 0.25)
    lat, counted = counted_bench_leg(
        card, "bench_quick", "latency",
        lambda: bench.run_latency(0.25, seconds=LATENCY_SECONDS,
                                  device="cuda"), 1, 1 + lat_blocks)
    launches.update(counted)
    check("error" not in lat and lat["blocks"] >= 3
          and lat["blocks"] == lat_blocks - lat["warmup_blocks"]
          and lat["p50_ms"] > 0 and isinstance(lat["stalls"], int)
          and lat["h2d_block_ms"] > 0, f"bench_quick/latency: {lat}")
    return launches


def wide_leg(phase, synth):
    """A wide leg's pipeline on the card and its capture, cut to whole
    periods, made once for everything that runs on it: (pipe, cu8 bytes,
    truth, seconds the making took)."""
    await_capture(synth, phase)
    t = time.perf_counter()
    pipe, raw, truth = bench.leg_pipeline(
        max_candidates=None, pallas=False, device="cuda",
        block_seconds=WIDE_BLOCK_S.get(phase), **WIDE_PLANS[phase])
    return pipe, bench.whole_tiles(pipe, raw), truth, time.perf_counter() - t


def wide_phase(card, phase, leg):
    """One of the bench's wide legs (WIDE_PLANS) on its wide_leg: three
    passes of decodes of its capture, then K1 on the decimated block of
    that shape (the whole capture, or block 1 of its stream), channelized
    on the card by the leg's own route.  Returns (launches, K1 case)."""
    plan = WIDE_PLANS[phase]
    pipe, raw, truth, capture_s = leg
    block_s = WIDE_BLOCK_S.get(phase)
    iters = 1 if phase in ("band_760", "kchan_2000") else 4
    blocks = 1 if block_s is None \
        else -(-(len(raw) // 2) // pipe.core_raw_samples(block_s))
    out, launches = counted_bench_leg(
        card, phase, "wall",
        lambda: bench.run_leg(pipe, raw, truth, iters, block_seconds=block_s),
        blocks, 1 + bench.PASSES * iters, capture_s=capture_s)
    check_wall_leg(phase, out)
    active = {c for c, *_ in truth}
    check(active == set(stimulus.active_channels(
        plan["channels"], plan["active_every"], plan.get("also_active", ()))),
        f"{phase}: bursts on channels {sorted(active)}")
    if phase == "kchan_2000":
        check({0, 1999} <= active, "kchan_2000: no burst on an edge channel")
    torch.cuda.reset_peak_memory_stats()
    ch = pipe.channelizer
    seg = raw if block_s is None else block_segment(pipe, raw, block_s, 1)[0]
    seg_dev = torch.from_numpy(seg).cuda()
    y = channelize_raw(seg_dev, ch, "cu8", False)
    torch.cuda.synchronize()
    check(y.shape[0] == plan["channels"], f"{phase}: y {tuple(y.shape)}")
    k1 = k1_case(card, y, route=f"{phase}/{pipe.cfg.chan_impl}",
                 fs=pipe.cfg.fs, block_seconds=block_s or plan["seconds"])
    emit(phase, card, leg="front", chan_impl=ch.impl,
         shape=list(y.shape), periods=seg_dev.numel() // (2 * ch.p_in),
         front_ms=cuda_ms(lambda: channelize_raw(seg_dev, ch, "cu8", False)),
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    return launches, k1


def k2_wide_phase(card, legs):
    """K2 against its plain version at 64 and 76 channels, on the
    32-period-aligned 1 s block of the wide legs' own capture bytes, then
    K1's trigger sets on the two outputs.  They may differ only on
    channels without traffic, and only where flip_by_suppression finds
    every differing firing decision of the flip's sync window within the
    err tolerance of the threshold on both sides; each such decision is
    printed with its readings."""
    p_in = period_for(FS // 4000)[0]
    out = []
    for phase in ("wide_64", "wide_76"):
        pipe, raw, _truth, _s = legs[phase]
        offsets = pipe.f_offsets
        b = len(raw) // (2 * p_in) // 32 * 32
        torch.cuda.reset_peak_memory_stats()
        res, y_k, y_p = k2_case(card, raw[: b * p_in * 2], offsets, FS, True,
                                b, 0, False,
                                route=f"k2_wide/{len(offsets)}ch")
        ys = [y.reshape(len(offsets), -1, 2) for y in (y_k, y_p)]
        (err_k, fr_k), (err_p, fr_p) = (sync.sync_scan(y) for y in ys)
        of_k, of_p = (trigger_set(e, f, MAX_CANDIDATES)
                      for e, f in ((err_k, fr_k), (err_p, fr_p)))
        e_k, e_p = err_k.cpu().numpy(), err_p.cpu().numpy()
        active = set(stimulus.active_channels(
            len(offsets), WIDE_PLANS[phase]["active_every"]))
        flips = []
        for c, t in sorted(of_k ^ of_p):
            explained, decisions = flip_by_suppression(e_k, e_p, c, t)
            flips.append(dict(channel=c, t=t, on_kernel_side=(c, t) in of_k,
                              idle_channel=c not in active,
                              explained=explained, decisions=decisions))
        # readings: [K2's output, its plain version's]
        emit("k2_wide", card, channels=len(offsets), periods=b,
             max_abs_err=res["max_abs_err"], triggers=len(of_k),
             trigger_flips=flips,
             peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
        check(len(of_k) > 0, "k2_wide: no trigger")
        check(all(f["explained"] and f["idle_channel"] for f in flips),
              "k2_wide: a trigger differs between K2's output and its plain "
              f"version's on traffic or away from the threshold: {flips}")
        out.append(res)
    return out


def stages_phase(card, synth, band):
    """stage_times' table at the slice's 2 s block (block 1 of the slice's
    capture) and at the band's block (band: its wide_leg): every stage
    timed and counted, the kernels' sum within the program's event time."""
    await_capture(synth, "slice")
    wide, freqs, fc, _truth = stimulus.make_capture(**CAPTURES["slice"])
    band_pipe, band_raw = band[:2]
    shapes = (("slice", slice_pipeline(freqs, fc, "cuda"),
               stimulus.to_u8(wide[: int(3 * SLICE_BLOCK_S * FS)]),
               SLICE_BLOCK_S),
              ("band", band_pipe, band_raw, WIDE_BLOCK_S["band_760"]))
    for shape, pipe, cap, block_s in shapes:
        torch.cuda.reset_peak_memory_stats()
        table = stage_table(pipe, cap, block_s)
        emit("stages", card, shape=shape, **table,
             peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
        rows = table["stages"]
        check([r["stage"] for r in rows] == list(STAGES),
              f"stages/{shape}: {[r['stage'] for r in rows]}")
        check(all(r["delta_ms"] > 0 and r["kernels"] > 0 for r in rows),
              f"stages/{shape}: a stage without time or kernels")
        check(rows[1]["kernels"] == 1, f"stages/{shape}: sync is "
              f"{rows[1]['kernels']} kernels, want K1 alone")
        check(0 < table["kernel_ms"] <= table["program_ms"] * 1.05,
              f"stages/{shape}: kernels {table['kernel_ms']} ms in a "
              f"program of {table['program_ms']} ms")


def snr_phase(card):
    """snr_sweep on the card with the golden model beside it."""
    reset_launches()
    t = time.perf_counter()
    rows = list(snr_sweep.sweep(SNR_POINTS, SNR_TRIALS, 40, True, "cuda"))
    launched = main_path_launches()
    emit("snr", card, trials=SNR_TRIALS, rows=rows, launches=launched,
         wall_s=time.perf_counter() - t)
    check(rows[-1] == {"snr_db": 20.0, "port_rate": 1.0, "golden_rate": 1.0},
          f"snr: at 20 dB {rows[-1]}")
    check(all(0.0 <= r["port_rate"] <= 1.0 for r in rows)
          and rows[0]["port_rate"] <= rows[-1]["port_rate"],
          f"snr: rates {rows}")
    check(launched["sync_scan[stream]"] == len(SNR_POINTS) * SNR_TRIALS,
          f"snr: launches {launched}")
    return launched


def wide_run(card, synth, only=None):
    """The bench, width and measurement phases (those of `only`, or all):
    (launches, K1 cases, K2 cases).  Each wide leg's pipeline and capture
    are made once, for its own phase and for k2_wide and stages."""
    launches, k1, k2, legs = Counter(), [], [], {}
    run = (lambda phase: only is None or phase in only)
    if run("bench_quick"):
        launches.update(bench_quick_phase(card, synth))
    for phase in WIDE_PLANS:
        if any(map(run, CAPTURE_PHASES[phase])):
            legs[phase] = wide_leg(phase, synth)
        if run(phase):
            counted, case = wide_phase(card, phase, legs[phase])
            launches.update(counted)
            k1.append(case)
    if run("k2_wide"):
        k2 = k2_wide_phase(card, legs)
    if run("stages"):
        stages_phase(card, synth, legs["band_760"])
    if run("snr"):
        launches.update(snr_phase(card))
    return launches, k1, k2


def captures_of(only) -> list[str]:
    """The captures that the phases of `only` (None: all) decode."""
    return [n for n, phases in CAPTURE_PHASES.items()
            if only is None or only & set(phases)]


def start_synthesis(names) -> dict:
    """One process a capture, all started together: each synthesizes its
    capture into stimulus.make_capture's store on disk, where the phase
    that needs it finds it after await_capture."""
    code = ("import json, sys; from vdlm2dec_tpu_torch import stimulus; "
            "stimulus.make_capture(**json.loads(sys.argv[1]))")
    return {n: subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(CAPTURES[n])], cwd=REPO,
        stdout=subprocess.DEVNULL) for n in names}


def await_capture(synth, name) -> None:
    check(synth[name].wait(timeout=900) == 0,
          f"the synthesis of the {name} capture failed")


def partial_run(card, only, synth) -> int:
    """The named mesh phases alone (work on them); no result line."""
    await_capture(synth, "slice")
    wide, freqs, fc, truth = stimulus.make_capture(**CAPTURES["slice"])
    raw = stimulus.to_u8(wide)
    with tempfile.TemporaryDirectory(prefix="vdl2_smoke_") as tmp:
        path = os.path.join(tmp, "cap.cu8")
        raw.tofile(path)
        if "mesh" in only:
            mesh_phase(card, raw, freqs, fc, truth)
        if "mesh_wideband" in only:
            mesh_wideband_phase(card, wide, freqs, fc, truth)
        if "cli_mesh" in only:
            cli_mesh_phase(card, path, freqs, fc,
                           cli_phase(card, path, "cu8", freqs, fc))
        if "multihost" in only:
            multihost_phase(card, path, freqs, fc, truth, len(raw) // 2)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    partial = MESH_PHASES + WIDE_PHASES
    ap.add_argument("--phases", default=None,
                    help="comma list of " + ", ".join(partial) + ": run "
                         "only these, and print no result line")
    only = ap.parse_args(argv).phases
    only = None if only is None else set(only.split(","))
    if only is not None and not only <= set(partial):
        ap.error(f"--phases takes {', '.join(partial)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 2
    synth = start_synthesis(captures_of(only))
    try:
        return run_phases(card_string(), only, synth)
    finally:
        for proc in synth.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def run_phases(card, only, synth) -> int:
    """Every phase (only: the named ones) on the card."""
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
    built = native.native_available()
    emit("deframer", card,
         deframer="native C++ (csrc/hostdec.cpp)" if built
         else "Python Unstuffer",
         library=str(native.library_path()) if built else None,
         build_s=time.perf_counter() - t)
    check(built, "the native deframer did not build or load")

    if only is not None:
        if only & set(WIDE_PHASES):
            wide_run(card, synth, only)
        if only & set(MESH_PHASES):
            partial_run(card, only, synth)
        print(card)
        print(json.dumps({"partial": sorted(only)}))
        return 0

    t = time.perf_counter()
    await_capture(synth, "slice")
    wide, freqs, fc, truth = stimulus.make_capture(**CAPTURES["slice"])
    raw = stimulus.to_u8(wide)
    await_capture(synth, "air")
    air_wide, air_freqs, air_fc, air_truth = stimulus.make_capture(
        **CAPTURES["air"])
    # the slices after the first three decode the capture's first CUT_SECONDS
    n_cut = int(CUT_SECONDS * FS)
    raw_cut = raw[: 2 * n_cut]
    caps = format_captures(wide[:n_cut], air_wide)
    emit("capture", card, channels=N_CHAN, seconds=SECONDS, fc=fc,
         bursts=len(truth), cut_seconds=CUT_SECONDS, air_fs=AIR_FS,
         air_channels=AIR_CHAN, air_seconds=AIR_SECONDS, air_fc=air_fc,
         air_bursts=len(air_truth), wait_s=time.perf_counter() - t)

    kern = {s: kernel_phase(card, raw, freqs, fc, s) for s in (2.0, 4.0)}
    k2, k1 = kernel_k2_phase(card, raw, freqs, fc, stimulus.to_u8(air_wide),
                             [f - air_fc for f in air_freqs])
    k1.append(kernel_air_phase(card, caps[2], air_freqs, air_fc))
    # launches of the main-path decodes, each counted from 0
    launches = slice_phase(card, raw, freqs, fc, truth)
    launches.update(slice_pallas_phase(card, raw, freqs, fc, truth))
    launches.update(slice_xla_phase(card, raw, freqs, fc, truth))
    for counted in slice_formats_phase(
            card, caps, freqs, fc, truth,
            (air_freqs, air_fc, air_truth)).values():
        launches.update(counted)
    with tempfile.TemporaryDirectory(prefix="vdl2_smoke_") as tmp:
        path = os.path.join(tmp, "cap.cu8")
        raw.tofile(path)
        cut_path = os.path.join(tmp, "cut.cu8")
        raw_cut.tofile(cut_path)
        cs16_path = os.path.join(tmp, "cut.cs16")
        caps[0].tofile(cs16_path)
        air_path = os.path.join(tmp, "air.f32")
        caps[2].tofile(air_path)
        readers = {"cu8": cli.CaptureReader(cut_path, "cu8"),
                   "cs16": cli.CaptureReader(cs16_path, "cs16")}
        k1.extend(kernel_modes_phase(card, raw_cut, readers["cu8"], freqs, fc))
        launches.update(slice_bf16_phase(card, raw_cut, freqs, fc, truth))
        launches.update(slice_fir_phase(card, readers["cu8"], freqs, fc,
                                        truth))
        launches.update(slice_nonfused_phase(card, readers, freqs, fc, truth))
        launches.update(live_phase(card, cut_path, freqs, fc, truth))
        mesh_launches, mesh_k1 = mesh_phase(card, raw, freqs, fc, truth)
        launches.update(mesh_launches)
        k1.append(mesh_k1)
        launches.update(mesh_wideband_phase(card, wide, freqs, fc, truth))
        processes_phase(card, path, air_path, freqs, fc, air_freqs, air_fc,
                        truth, len(raw) // 2)
    wide_launches, wide_k1, wide_k2 = wide_run(card, synth)
    launches.update(wide_launches)
    k1.extend(wide_k1)
    k2.extend(wide_k2)

    kernels = []
    for mode in sync.MODES:
        cases = [c[mode] for c in (kern[2.0], kern[4.0], *k1)]
        kernels.append(dict(
            name=f"sync_scan[{mode}]", route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES, launches=launches[f"sync_scan[{mode}]"],
            max_abs_err=max(max(c["err_max_abs"], c["fr_max_abs"])
                            for c in cases),
            **{key: cases[0][key] for key in KERNEL_KEYS}, library_ms=None))
    kernels.append(dict(
        name="chan_u8", route="cuda", source=K2_SOURCE, replaces=K2_REPLACES,
        launches=launches["chan_u8"],
        max_abs_err=max(c["max_abs_err"] for c in k2),
        **{key: k2[0][key] for key in KERNEL_KEYS}, library_ms=None,
        dense_route_ms=k2[0]["dense_route_ms"]))
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on the main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
