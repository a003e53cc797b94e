"""Multi-host decode: torch.distributed + a global (chan, time) mesh.

The scale-out axis, as the JAX package's parallel/multihost.py:

  * channels shard over each process's local devices ("chan" stays
    inside a host);
  * time blocks shard ACROSS processes: the only traffic between them is
    the 84 kHz halo exchange at each seam (HALO_LEFT + one burst window),
    one point-to-point send and receive between rank r and r +- 1;
  * every process keeps only its own time slice of the input
    (channelized locally, period-aligned) and emits frames for triggers
    inside its own shards: one output stream per process, no gather.

Worker entry (one process per host):

    python -m vdlm2dec_tpu_torch.parallel.multihost \
        --coordinator host0:9911 --num-processes 2 --process-id $I \
        --iq capture.cu8 --fc 136900000 136.975 136.875 ...

The halos travel over the backend the caller names: NCCL moves CUDA
tensors directly, staged on the rank's first card, and wants no card that
another rank uses (a rank may hold several); gloo takes CPU tensors, so
under gloo the halos are staged through host memory (and two ranks may
share a card).  launch_local(n) spawns n workers on this machine.
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .._tables import HALO_LEFT, unpack_results
from .sharding import (Mesh, burst_window, channelize_shard, copy_to, fetch_rows,
                       grid, packed_decode_step, raw_constants, shard_channels,
                       shard_raw)

# a receive that no peer answers fails after this long instead of hanging
COLLECTIVE_TIMEOUT_S = 600


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = "gloo") -> None:
    """torch.distributed bring-up (idempotent): rank process_id of
    num_processes, rendezvous at tcp://<coordinator>."""
    import torch.distributed as dist

    if (num_processes > 1 or coordinator) and not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def _world() -> tuple[int, int]:
    """(number of processes, this process's rank); (1, 0) outside a job."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(n_chan: int, n_time: int, local_devices) -> Mesh:
    """This process's columns of the (chan, time) mesh over all
    processes: the chan axis stays within a process and the time axis
    advances across processes, so rank r holds the consecutive time
    columns r * n_time / P onwards, on its local_devices taken down each
    column."""
    world, rank = _world()
    if n_time % world:
        raise ValueError("time shards must divide evenly across processes")
    t_per = n_time // world
    return Mesh(grid(local_devices, n_chan, t_per, time_major=True),
                time_start=rank * t_per)


class _Dispatched:
    """One dispatched window: its shards and the halo exchange in flight."""

    def __init__(self, shards, works, left, right, sent):
        self.shards = shards
        self.works = works
        self.left = left               # halo received from rank - 1
        self.right = right             # halo received from rank + 1
        self.sent = sent               # send buffers, alive until waited


class MultiHostDecoder:
    """Packed sharded decode where the time axis spans processes.

    decode_local(y_local): y_local is THIS process's (C, T_local, 2)
    decimated slice (T_local = T_global / n_processes, divisible by the
    per-process time-shard count).  Returns the candidate dicts whose
    triggers live in this process's shards, with global chan/t0.

    dispatch() posts the halo sends and receives and returns without
    waiting; fetch() waits for them, decodes the shards and fetches.
    Every process dispatches its windows in the same order from one
    thread, and the messages between two ranks match in that order, so
    several windows may be in flight."""

    def __init__(self, mesh: Mesh, max_candidates: int = 8,
                 max_symbols: int = 1024, max_out: int = 64,
                 raw_f_offsets=None, fs: int = 2_000_000,
                 sdrclk: int | None = None, lo_wrap: bool = True):
        from ..ops.channelizer import set_f32_matmul

        set_f32_matmul()
        self.mesh = mesh
        self._right = burst_window(max_symbols)
        self._step = packed_decode_step(max_candidates, max_symbols, max_out)
        self._consts = None
        if raw_f_offsets is not None:
            # raw-ingest path: each process channelizes its raw
            # period-aligned slice on its shards' devices
            from .._tables import period_for

            sdrclk = sdrclk if sdrclk is not None else fs // 4000
            self.p_in, self.p_out = period_for(sdrclk)
            self._consts = raw_constants(mesh, raw_f_offsets, fs, sdrclk,
                                         lo_wrap)

    def _comm_device(self) -> torch.device:
        """Where the halos are staged: host memory under gloo, the
        process's first card under NCCL."""
        import torch.distributed as dist

        if dist.get_backend() == "gloo":
            return torch.device("cpu")
        return self.mesh.devices[0][0]

    def _on_comm_device(self):
        """The staging card as the current device (a no-op under gloo):
        NCCL orders its transfers against, and work.wait() orders after
        them, the current stream of that card, whichever card the
        caller's current device is."""
        import contextlib

        dev = self._comm_device()
        return torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()

    def _post(self, shards: list) -> _Dispatched:
        """Post the exchange of the two seam halos of every channel row
        (stacked over the rows) with ranks r - 1 and r + 1."""
        world, rank = _world()
        if world == 1:
            return _Dispatched(shards, [], None, None, [])
        import torch.distributed as dist

        dev = self._comm_device()
        c = sum(row[0].shape[0] for row in shards)
        t_local = shards[0][0].shape[1]
        ops, sent = [], []
        left = right = None
        if rank < world - 1:
            edge = torch.cat([copy_to(row[-1][:, -HALO_LEFT:], dev)
                              for row in shards]).contiguous()
            right = torch.empty((c, min(self._right, t_local), 2),
                                dtype=torch.float32, device=dev)
            ops += [dist.P2POp(dist.isend, edge, rank + 1),
                    dist.P2POp(dist.irecv, right, rank + 1)]
            sent.append(edge)
        if rank > 0:
            edge = torch.cat([copy_to(row[0][:, :self._right], dev)
                              for row in shards]).contiguous()
            left = torch.empty((c, min(HALO_LEFT, t_local), 2),
                               dtype=torch.float32, device=dev)
            ops += [dist.P2POp(dist.isend, edge, rank - 1),
                    dist.P2POp(dist.irecv, left, rank - 1)]
            sent.append(edge)
        with self._on_comm_device():
            works = dist.batch_isend_irecv(ops)
        return _Dispatched(shards, works, left, right, sent)

    def dispatch(self, y_local) -> _Dispatched:
        """Place this process's slice on its shards and post the halo
        exchange WITHOUT waiting for it, so the caller can channelize the
        next window while this one's rendezvous proceeds.  All dispatch()
        calls must come from one thread, in the same order on every
        process."""
        return self._post(shard_channels(self.mesh, y_local))

    def dispatch_raw(self, x_local, period0: int) -> _Dispatched:
        """dispatch() for the raw-ingest path (requires raw_f_offsets at
        construction): x_local is THIS process's raw (T_raw_local, 2)
        float32 plane slice, period-aligned; period0 is the GLOBAL
        channelizer-period index of the dispatched span's first sample.
        Each shard channelizes on its device: no decimated round trip."""
        if self._consts is None:
            raise ValueError("MultiHostDecoder was built without "
                             "raw_f_offsets")
        x = shard_raw(self.mesh, x_local, self.p_in)
        return self._post([
            [channelize_shard(xs, *self._consts[ci][tj], self.p_in, period0,
                              self.mesh.time_start + tj)
             for tj, xs in enumerate(row)] for ci, row in enumerate(x)])

    def fetch(self, out: _Dispatched) -> list[dict]:
        """Finish a dispatch(): wait for its halos, decode this process's
        shards and unpack the candidate rows whose triggers live in them.
        Under NCCL the wait orders the staging card's current stream after
        the receives; halo_exchange's copy_to then records its event on
        that stream, so a shard on another card of this process reads its
        halo only once it has arrived."""
        if out.works:
            with self._on_comm_device():
                for work in out.works:
                    work.wait()
        out.sent.clear()
        c_local = out.shards[0][0].shape[0]

        def rows(edge):
            return None if edge is None else list(edge.split(c_local))

        bufs = self._step(self.mesh, out.shards, rows(out.left),
                          rows(out.right))
        return unpack_results(fetch_rows(bufs))

    def decode_local(self, y_local) -> list[dict]:
        return self.fetch(self.dispatch(y_local))


# -- worker --------------------------------------------------------------------
def _worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="vdlm2t-multihost-torch",
        description="one per-host worker of a multi-host decode job",
    )
    ap.add_argument("freqs", nargs="*", type=float, help="frequencies in MHz")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--chan-shards", type=int, default=1)
    ap.add_argument("--time-shards", type=int, default=0,
                    help="global time shards (default: all processes' "
                         "local devices / chan)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of this worker's shards (cuda, "
                         "cuda:1, cpu)")
    ap.add_argument("--local-devices", default=None,
                    help="comma list of torch devices, one per local shard "
                         "down each time column (an entry may repeat); "
                         "default: --device for every shard")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="torch.distributed backend of the halo exchange "
                         "(default: nccl on CUDA devices, gloo on the CPU; "
                         "nccl takes no card that another process uses)")
    ap.add_argument("--iq", default=None, help="capture path (shared fs)")
    ap.add_argument("--format", default="cu8",
                    choices=("cu8", "cs16", "cf32", "f32real"),
                    help="capture sample format (f32real = airspy-style "
                         "real capture; channels sit at fc + fs/4)")
    ap.add_argument("--chan-impl", default="matmul",
                    choices=("matmul", "dft", "pfb"),
                    help="channelizer implementation (dft/pfb: residue-"
                         "space variants for high channel counts)")
    ap.add_argument("--y-npy", default=None,
                    help="decimated (C, T) complex .npy (test input)")
    ap.add_argument("--fs", type=int, default=2_000_000)
    ap.add_argument("--fc", type=float, default=None)
    ap.add_argument("--max-candidates", type=int, default=8)
    ap.add_argument("--max-symbols", type=int, default=256)
    ap.add_argument("--max-out", type=int, default=64)
    ap.add_argument("--block-seconds", type=float, default=0.0,
                    help="stream the capture in windows of this length "
                         "(constant memory per host; 0 = one-shot)")
    ap.add_argument("--timing", action="store_true",
                    help="windowed mode: print a STATS json line with the "
                         "post-warmup wall time and global samples covered "
                         "(window 0 = warmup, excluded)")
    ap.add_argument("--checkpoint", default=None,
                    help="windowed mode: per-host resume state (cursor, "
                         "burst-span suppression, flight tracker) is kept "
                         "in <path>.p<process_id>; on restart every host "
                         "resumes at the earliest unfinished window across "
                         "hosts (the exchange sequence must realign) and "
                         "skips re-emitting windows it already emitted.  "
                         "Exactly-once output under a clean stop; a hard "
                         "kill between emit and checkpoint re-emits at "
                         "most one window on restart")
    ap.add_argument("--abort-after-window", type=int, default=-1,
                    help="test hook: exit cleanly right after this "
                         "window's result is emitted and checkpointed")
    ap.add_argument("--dispatch-depth", type=int, default=2,
                    help="windowed mode: how many windows may be "
                         "dispatched (channelized + their halo exchange "
                         "posted) before the oldest is fetched.  Depth 1 "
                         "is fetch-before-next-dispatch; depth 2 (default) "
                         "hides one window's rendezvous + emit/IO skew "
                         "behind the next window's channelize; deeper "
                         "absorbs multi-window skew spikes at ~one window "
                         "slice of extra memory per level")
    ap.add_argument("--output", choices=("frames", "json", "text"),
                    default="frames",
                    help="frames: machine-readable 'FRAME chan t0 hex' "
                         "lines (default); json/text: the full single-host "
                         "decode surface (ACARS/XID/CPDLC) per host")
    ap.add_argument("--station", default="", help="station id for json")
    ap.add_argument("--start-time", type=float, default=None,
                    help="capture start unix time (json/text timestamps)")
    ap.add_argument("--netjson", default=None, metavar="ADDR[:PORT]",
                    help="also send each JSON record via UDP (out.c -j)")
    ap.add_argument("--netsbs", default=None, metavar="ADDR[:PORT]",
                    help="also send SBS position lines via TCP (out.c -s)")
    ap.add_argument("--label-filter", default=None,
                    help="colon-separated ACARS labels to keep (main.c -b)")
    args = ap.parse_args(argv)

    # fail fast on flag combinations that would be silently inert
    if args.checkpoint and not args.block_seconds:
        ap.error("--checkpoint requires --block-seconds (windowed mode)")
    if args.abort_after_window >= 0 and not args.block_seconds:
        ap.error("--abort-after-window requires --block-seconds")
    fdec_active = (args.output != "frames" or args.netjson or args.netsbs)
    if args.label_filter and not fdec_active:
        ap.error("--label-filter needs --output json|text or a net sink "
                 "(FRAME lines are unfiltered by design)")
    if (args.station or args.start_time is not None) and not fdec_active:
        print("warning: --station/--start-time have no effect on "
              "--output frames without a net sink", file=sys.stderr)

    # clean-stop drain: SIGTERM/SIGQUIT (sent to ALL workers by the job
    # manager) sets a flag honored at window boundaries: the windows in
    # flight are fetched, emitted and checkpointed before exit, so a
    # restart resumes exactly-once.  A worker stopped alone leaves its
    # peers to fail on their next exchange; their checkpoints are still
    # consistent (written post-emit).
    stop_requested = False

    def _request_stop(signum, frame):
        nonlocal stop_requested
        stop_requested = True

    import signal as _signal
    import threading as _threading

    if _threading.current_thread() is _threading.main_thread():
        for _sig in (_signal.SIGTERM, getattr(_signal, "SIGQUIT", None)):
            if _sig is not None:
                try:
                    _signal.signal(_sig, _request_stop)
                except (ValueError, OSError):
                    pass
        # ops/debug aid: SIGUSR1 dumps every thread's Python stack to a
        # per-process file (a hung exchange is otherwise opaque)
        dump_dir = os.environ.get("VDLM2_STACKDUMP_DIR")
        if dump_dir and hasattr(_signal, "SIGUSR1"):
            import faulthandler

            _dump_f = open(os.path.join(
                dump_dir, f"stacks_p{args.process_id}_{os.getpid()}.txt"),
                "w")
            faulthandler.register(_signal.SIGUSR1, file=_dump_f,
                                  all_threads=True)

    # this worker's devices, one per local shard down each time column
    if args.local_devices:
        local = args.local_devices.split(",")
        if args.time_shards:
            t_local_shards = args.time_shards // args.num_processes
        else:
            t_local_shards = len(local) // args.chan_shards
    else:
        t_local_shards = max(1, args.time_shards // args.num_processes)
        local = [args.device] * (args.chan_shards * t_local_shards)
    n_time = args.time_shards or t_local_shards * args.num_processes
    dev0 = torch.device(local[0])
    backend = args.backend or ("nccl" if dev0.type == "cuda" else "gloo")
    if dev0.type == "cuda":
        torch.cuda.set_device(dev0)
    initialize(args.coordinator, args.num_processes, args.process_id, backend)
    try:
        return _run_worker(args, n_time, local, lambda: stop_requested)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _run_worker(args, n_time: int, local: list, stop_requested) -> int:
    """The worker's decode, inside its process group."""
    mesh = global_mesh(args.chan_shards, n_time, local)
    dev0 = mesh.devices[0][0]
    t_shards_per_host = mesh.shape[1]

    def make_dec(raw_f_offsets=None, lo_wrap=True):
        return MultiHostDecoder(
            mesh,
            max_candidates=args.max_candidates,
            max_symbols=args.max_symbols,
            max_out=args.max_out,
            raw_f_offsets=raw_f_offsets,
            fs=args.fs,
            lo_wrap=lo_wrap,
        )

    from .._tables import PipelineConfig
    from ..pipeline import Pipeline

    prev_end: dict[int, int] = {}

    fdec = None
    if args.output != "frames" or args.netjson or args.netsbs:
        # full single-host output surface, one decoded stream per host.
        # Frame ownership is per-shard (the trigger's shard), so streams
        # never overlap and merging = concatenating.  Flight-tracker
        # (route/registration MRU) state is per host: with time sharded
        # across hosts a flight seen in different time windows may hit
        # different trackers, as N reference instances on split captures
        # would; aggregate downstream if needed.
        from ..host.decoder import FrameDecoder
        from ..host.output import OutputConfig

        fdec = FrameDecoder(
            OutputConfig(
                verbose=2 if args.output == "text" else 0,
                jsonout=args.output == "json",
                station_id=args.station,
                net_json_addr=args.netjson,
                net_sbs_addr=args.netsbs,
            ),
            label_filter=args.label_filter,
            time_base=args.start_time,
        )

    def emit(pipe, cands, t_off):
        for b in pipe._finish(cands, t_offset=t_off, prev_end=prev_end):
            if fdec is not None:
                fdec.process_burst(b)
            if args.output == "frames":
                for fr in b.frames:
                    print(f"FRAME {b.channel} {b.t0} {bytes(fr).hex()}",
                          flush=True)

    if args.y_npy is not None:
        dec = make_dec()
        y = np.load(args.y_npy)                      # (C, T) complex
        t_local = y.shape[1] // args.num_processes
        lo = args.process_id * t_local
        cands = dec.decode_local(y[:, lo: lo + t_local])
        pipe = Pipeline(PipelineConfig(
            freqs_hz=[0.0] * y.shape[0], fs=args.fs, fc_hz=args.fc or 0.0,
            max_symbols=args.max_symbols), device=dev0)
        emit(pipe, cands, 0)
        print(f"DONE {args.process_id} {len(cands)}", flush=True)
        return 0

    from .._tables import stream_geometry
    from ..io.sdr import CaptureReader, choose_fc, choose_fc_airspy
    from ..ops.channelizer import Channelizer
    from ..ops.demod import pack_complex

    real_input = args.format == "f32real"
    freqs_hz = [f * 1e6 for f in args.freqs]
    if args.fc is not None:
        fc = args.fc
    elif real_input:
        fc = choose_fc_airspy([int(f) for f in freqs_hz], args.fs)
    else:
        fc = choose_fc([int(f) for f in freqs_hz], args.fs)
    reader = CaptureReader(args.iq, args.format)
    # airspy-style real captures put the band at fc + fs/4 (the
    # single-host pipeline builds its channelizer the same way)
    f0 = fc + args.fs / 4 if real_input else fc
    f_offsets = [f - f0 for f in freqs_hz]
    ch = Channelizer(f_offsets, fs=args.fs, real_input=real_input,
                     impl=args.chan_impl, device=dev0)
    p_in, p_out = ch.p_in, ch.p_out
    periods = len(reader) // p_in
    n_cands = 0
    # raw ingest: each shard channelizes its own raw planes (the dense
    # matmul body).  The dft/pfb residue-space impls channelize the
    # process's slice on its first device and shard the decimated block
    # (their tables are not in the shard body); matmul is the default.
    raw_ingest = args.chan_impl == "matmul"
    dec = make_dec(raw_f_offsets=f_offsets if raw_ingest else None,
                   lo_wrap=ch.lo_wrap)

    phase_s = {"channelize": 0.0, "collective_decode": 0.0, "finish": 0.0}

    def dispatch_span(lo_p: int, span_p: int):
        """Dispatch the decode of [lo_p, lo_p+span_p) periods across the
        mesh: this process reads only ITS period sub-slice (local file
        read, no raw traffic between hosts) and posts the halo exchange
        WITHOUT waiting for the result."""
        per_host = span_p // args.num_processes
        my_lo = lo_p + args.process_id * per_host
        x = reader.read(my_lo * p_in, per_host * p_in)
        tc = time.monotonic()
        if raw_ingest:
            if np.iscomplexobj(x):
                xp = pack_complex(x)
            else:                        # f32real: imag plane is zero
                xp = np.stack([x.astype(np.float32),
                               np.zeros_like(x, np.float32)], axis=-1)
            out = dec.dispatch_raw(xp, lo_p)
        else:
            out = dec.dispatch(ch.channelize(x, period0=my_lo))
        phase_s["channelize"] += time.monotonic() - tc
        return out

    def fetch_span(out):
        tc = time.monotonic()
        cands = dec.fetch(out)
        phase_s["collective_decode"] += time.monotonic() - tc
        return cands

    pipe = Pipeline(PipelineConfig(
        freqs_hz=freqs_hz, fs=args.fs, fc_hz=float(fc),
        real_input=real_input, max_symbols=args.max_symbols), device=dev0)
    if not args.block_seconds:
        per_host = periods // args.num_processes
        per_host -= per_host % t_shards_per_host
        cands = fetch_span(dispatch_span(0, per_host * args.num_processes))
        emit(pipe, cands, 0)
        print(f"DONE {args.process_id} {len(cands)}", flush=True)
        return 0

    # windowed streaming: overlapping extended windows (core + halo
    # margins, like the single-host stream); window-edge shards see zero
    # halos only in regions the core filter discards, so every owned
    # burst has real margins; memory per host = one window slice.
    # Window w+1 is channelized and dispatched before window w's result
    # is fetched (--dispatch-depth), so the per-window rendezvous and the
    # skew of emit/file-IO between processes overlap with compute.
    import json as _json
    from collections import deque

    from ..host.checkpoint import load_checkpoint, save_checkpoint
    from ..host.flights import FlightTracker

    lmarg_p, _rm, core_p, total_p = stream_geometry(
        p_in, p_out, args.fs, args.max_symbols, args.block_seconds,
        align=args.num_processes * t_shards_per_host)
    lmarg_dec = lmarg_p * p_out
    core_dec = core_p * p_out
    n_win = -(-periods // core_p)
    t_warm = None

    # checkpoint/resume: my_done = last window THIS host emitted and
    # persisted.  Every host must replay the same exchange sequence, so
    # the shared resume point is the all-gathered minimum of the per-host
    # cursors; a host ahead of it re-decodes those windows (keeping the
    # exchanges aligned) but skips re-emitting them.  Output is
    # exactly-once per host under a clean stop (SIGTERM drain,
    # --abort-after-window); a hard kill between emit and the checkpoint
    # rename re-emits AT MOST the one in-flight window on restart.
    ckpt_path = (f"{args.checkpoint}.p{args.process_id}"
                 if args.checkpoint else None)
    tracker = fdec.flights if fdec is not None else FlightTracker()
    # the guard pins EVERYTHING that changes window content or
    # channel-index meaning: prev_end keys are channel indices and FRAME
    # lines carry them, so a changed frequency plan (or fc/format/impl/
    # window size) would silently corrupt a resume that only checked the
    # window geometry
    geom = {"core_p": core_p, "n_win": n_win,
            "num_processes": args.num_processes,
            "capture_samples": len(reader), "fs": args.fs,
            "freqs_hz": [float(f) for f in freqs_hz],
            "fc": float(fc), "format": args.format,
            "chan_impl": args.chan_impl,
            "max_symbols": args.max_symbols}
    my_done = -1
    if ckpt_path and os.path.exists(ckpt_path):
        my_done, extra = load_checkpoint(ckpt_path, tracker)
        if extra.get("geom") != geom:
            raise SystemExit(
                f"checkpoint {ckpt_path} was written with a different job "
                f"geometry ({extra.get('geom')} vs {geom}); resuming would "
                "lose or duplicate frames: use the original flags or "
                "remove the checkpoint")
        prev_end.update({int(k): int(v)
                         for k, v in extra["prev_end"].items()})
    resume_w = _min_over_processes(my_done, dec) + 1

    n_timed = 0              # windows finished after warmup

    def finish_window(wi: int, out) -> int:
        nonlocal n_timed
        cands = [cd for cd in fetch_span(out)
                 if lmarg_dec <= cd["t0"] < lmarg_dec + core_dec]
        # replayed windows (wi <= my_done) still count as timed: their
        # samples were fetched and decoded, only emit is skipped
        if wi != resume_w:
            n_timed += 1
        if wi <= my_done:
            # replayed for alignment only: this host already emitted it
            # (prev_end and the flight tracker came from the checkpoint)
            return 0
        tf0 = time.monotonic()
        emit(pipe, cands, wi * core_dec - lmarg_dec)
        phase_s["finish"] += time.monotonic() - tf0
        if ckpt_path:
            save_checkpoint(
                ckpt_path, wi, tracker,
                extra={"geom": geom,
                       "prev_end": {str(k): int(v)
                                    for k, v in prev_end.items()}})
        return len(cands)

    # --abort-after-window N clamps the window range: window N is
    # finished by the tail flush below and nothing further is
    # dispatched, so all processes exit with no exchange in flight
    stop_w = n_win
    if 0 <= args.abort_after_window < n_win:
        stop_w = args.abort_after_window + 1
    depth = max(1, args.dispatch_depth)
    pending: deque = deque()   # (wi, dispatched window), oldest first
    for wi in range(resume_w, stop_w):
        if stop_requested():
            # SIGTERM drain: stop dispatching; the tail flush below
            # finishes (fetch+emit+checkpoint) the pending windows
            break
        out = dispatch_span(wi * core_p - lmarg_p, total_p)
        if wi == resume_w:
            # the first (resumed) window carries the warmup (kernel
            # build, first exchange) and is finished synchronously
            n_cands += finish_window(wi, out)
            t_warm = time.monotonic()
            for k in phase_s:
                phase_s[k] = 0.0
        else:
            pending.append((wi, out))
            if len(pending) >= depth:
                n_cands += finish_window(*pending.popleft())
    while pending:
        n_cands += finish_window(*pending.popleft())
    if args.timing and t_warm is not None and n_timed:
        print("STATS " + _json.dumps({
            "pid": args.process_id,
            "timed_s": time.monotonic() - t_warm,
            "timed_windows": n_timed,
            "global_samples_per_window": core_p * p_in,
            "phase_s": {k: round(v, 3) for k, v in phase_s.items()},
        }), flush=True)
    print(f"DONE {args.process_id} {n_cands}", flush=True)
    return 0


def _min_over_processes(value: int, dec: MultiHostDecoder) -> int:
    """The smallest value any process holds: an all-gather of one int."""
    world, _rank = _world()
    if world == 1:
        return value
    import torch.distributed as dist

    mine = torch.tensor([value], dtype=torch.int64,
                        device=dec._comm_device())
    every = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    return min(int(v.item()) for v in every)


# -- local launcher --------------------------------------------------------------
def launch_local(num_processes: int, worker_args: list[str],
                 local_devices: int = 4, timeout: float = 600.0,
                 cpu_sets: list[str] | None = None, device="cuda",
                 backend: str | None = None, threads: int = 1):
    """Spawn num_processes workers on this machine, each with
    local_devices shards, returning each process's stdout.  The path
    between processes is real: they talk through torch.distributed.
    device is one entry for every worker or a list with one per worker;
    an entry is one torch device name or a comma list of them, over which
    the worker's shards are laid in turn (its --local-devices).  backend
    None leaves the choice to the worker (nccl on CUDA devices, gloo on
    the CPU); nccl takes no card that is in two workers' lists.
    cpu_sets pins worker i to taskset set cpu_sets[i]; CPU workers get
    `threads` compute threads each, so several jobs can share a
    machine."""
    import socket
    import subprocess
    import tempfile

    entries = ([device] * num_processes if isinstance(device, str)
               else list(device))
    if len(entries) != num_processes:
        raise ValueError(f"{len(entries)} devices for {num_processes} workers")
    devices = [entry.split(",") for entry in entries]
    if backend == "nccl":
        # a worker's "cuda" is its first card
        cards = [{"cuda:0" if d == "cuda" else d for d in mine}
                 for mine in devices]
        for i, mine in enumerate(cards):
            for other in cards[i + 1:]:
                shared = sorted(mine & other)
                if shared:
                    raise ValueError(
                        f"nccl needs each card in one worker's list, and "
                        f"{shared[0]} is in two; workers that share a card "
                        f"exchange their halos over gloo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[2])
    procs = []
    files = []
    try:
        for pid in range(num_processes):
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (root, env.get("PYTHONPATH")) if p)
            mine = devices[pid]
            if torch.device(mine[0]).type == "cpu":
                env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = str(threads)
            pin = (["taskset", "-c", cpu_sets[pid]] if cpu_sets else [])
            # stdout/stderr go to FILES, not pipes: this launcher joins
            # the workers one at a time, and a worker whose un-drained
            # pipe fills (64 KB) blocks mid-emit, never posts its next
            # exchange, and stalls every OTHER worker in theirs.  Files
            # have no backpressure, as in production where each host owns
            # its stdout.
            of = tempfile.TemporaryFile()
            ef = tempfile.TemporaryFile()
            files.append((of, ef))
            cmd = [sys.executable, "-m",
                   "vdlm2dec_tpu_torch.parallel.multihost",
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(num_processes),
                   "--process-id", str(pid),
                   "--device", mine[0], "--local-devices",
                   ",".join(mine[i % len(mine)]
                            for i in range(local_devices))]
            if backend:
                cmd += ["--backend", backend]
            procs.append(subprocess.Popen(pin + cmd + worker_args,
                                          stdout=of, stderr=ef, env=env))
        outs = []
        # one shared deadline for the whole job, not a fresh `timeout`
        # per worker
        deadline = time.monotonic() + timeout
        for p, (of, ef) in zip(procs, files):
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
            of.seek(0)
            ef.seek(0)
            out, err = of.read(), ef.read()
            if p.returncode != 0:
                raise RuntimeError(
                    f"worker failed ({p.returncode}):\n{err.decode()[-2000:]}"
                )
            outs.append(out.decode())
        return outs
    finally:
        # never leave live workers behind, on a timeout or a failure
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for of, ef in files:
            of.close()
            ef.close()


if __name__ == "__main__":
    sys.exit(_worker_main())
