"""Sharded decode over a (channel, time) mesh of torch devices.

The two parallel axes, as the JAX package's parallel/sharding.py:
  * "chan"  channels are independent; each row of the mesh decodes its
            own slice of them;
  * "time"  overlap-save time blocks of each channel's stream.
            Neighbouring time shards exchange halos of the 84 kHz stream:
              - left halo (HALO_LEFT samples): matched-filter ring + sync
                window + trigger hysteresis;
              - right halo (one burst window): a burst whose trigger lands
                near the shard's end is demodulated from samples its right
                neighbour owns.  The shard that holds the trigger owns the
                burst, so no burst comes out twice.

Raw input needs no halo: the integrate-and-dump channelizer is local to
each 4*sdrclk-sample period, so raw blocks are cut on period boundaries
and only the 24x cheaper decimated stream crosses shards.

Where JAX has a device mesh and shard_map, this module has a Mesh of
torch devices and a loop: one process drives every device of its mesh,
each shard is a tensor on its device, the work is enqueued device by
device (asynchronously on CUDA devices) and the host fetches once.  A
device may appear in a mesh more than once (several shards on one card,
or on the CPU in the tests): the counterpart of XLA's virtual host
devices.  jax.lax.ppermute along "time" becomes a copy of the
neighbour's edge to the shard's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._tables import (HALO_LEFT, aggregation_matrix, lo_tables, period_for,
                       unpack_results)
from ..ops.channelizer import channelize_matmul, set_f32_matmul
from ..ops.demod import pack_complex
from ..pipeline import device_decode_packed


def burst_window(max_symbols: int) -> int:
    return 17 + 7 + 8 * max_symbols


def globalize_t0(buf: torch.Tensor, shard_off: int) -> torch.Tensor:
    """Add a shard's global time offset to the packed t0 meta word (bytes
    2052:2056 of the packed-row layout, _tables.PACKED_ROW_BYTES): shared
    by every sharded decode body."""
    t0 = buf[:, 2052:2056].contiguous().view(torch.int32) + shard_off
    return torch.cat([buf[:, :2052], t0.view(torch.uint8), buf[:, 2056:]],
                     dim=1)


@dataclass(frozen=True)
class Mesh:
    """An (n_chan, n_time) grid of torch devices with the axes ("chan",
    "time"): devices[ci][tj] holds channel slice ci of time block tj.

    In a multi-process job each process holds its own columns of the
    global mesh: time_start is the global index of its first column."""
    devices: tuple
    time_start: int = 0
    axis_names = ("chan", "time")

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])


def _device(d) -> torch.device:
    """A device as tensors report it: a CUDA device carries its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def grid(devices, n_chan: int, n_time: int, time_major: bool = False) -> tuple:
    """The first n_chan * n_time devices as an (n_chan, n_time) tuple of
    tuples, chan-major, or time-major (consecutive devices down a time
    column) when asked."""
    devices = [_device(d) for d in devices]
    n = n_chan * n_time
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    if time_major:
        return tuple(tuple(devices[tj * n_chan + ci] for tj in range(n_time))
                     for ci in range(n_chan))
    return tuple(tuple(devices[ci * n_time + tj] for tj in range(n_time))
                 for ci in range(n_chan))


def make_mesh(n_chan: int, n_time: int, devices=None) -> Mesh:
    """A mesh over the visible CUDA cards, or over the given devices
    (torch devices or their names; an entry may repeat).  Raises
    ValueError when there are fewer than n_chan * n_time."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(grid(devices, n_chan, n_time))


def copy_to(src: torch.Tensor, device: torch.device) -> torch.Tensor:
    """src on device, ordered after the work that produces it: a copy
    between two cards waits on an event recorded on the sender's
    stream, not only on the receiver's own."""
    if src.device == device:
        return src
    if src.is_cuda and device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(src.device))
        torch.cuda.current_stream(device).wait_event(done)
    # a copy into pageable host memory must have landed when this returns
    return src.to(device, non_blocking=device.type == "cuda")


def halo_exchange(row: list, left: int, right: int, left_edge=None,
                  right_edge=None) -> list:
    """The shards of one channel row along "time", each (C_local,
    T_local, 2) on its own device -> the same shards with their
    neighbours' edge samples around them.

    left_edge / right_edge are the halos of the row's two ends where they
    came from another process; a missing neighbour (the stream's edge)
    gives zeros, as the scalar chain's zero history at stream start."""
    n = len(row)
    out = []
    for j, y in enumerate(row):
        parts = []
        if left > 0:
            # the last `left` samples of the left neighbour
            if j > 0:
                parts.append(copy_to(row[j - 1][:, -left:], y.device))
            elif left_edge is not None:
                parts.append(copy_to(left_edge, y.device))
            else:
                parts.append(torch.zeros_like(y[:, -left:]))
        parts.append(y)
        if right > 0:
            if j < n - 1:
                parts.append(copy_to(row[j + 1][:, :right], y.device))
            elif right_edge is not None:
                parts.append(copy_to(right_edge, y.device))
            else:
                parts.append(torch.zeros_like(y[:, :right]))
        out.append(torch.cat(parts, dim=1))
    return out


def channelize_shard(x: torch.Tensor, lo_r: torch.Tensor, lo_i: torch.Tensor,
                     a: torch.Tensor, ang: torch.Tensor, p_in: int, period0,
                     time_index: int) -> torch.Tensor:
    """Dense-matmul channelize of one shard's raw planes:
    x (T_raw_local, 2) -> (C_local, T84_local, 2).

    period0 is the global channelizer-period index of the dispatched
    span's first sample and time_index the shard's global position along
    "time"; the period index and the angle are formed in float32, as the
    JAX package forms them, so the continuous LO (lo_wrap=False) gives
    its phases.  With the reference's wrapped LO (ang = 0) the phase is
    exactly 1."""
    b_local = x.shape[0] // p_in
    b0 = np.float32(period0) + np.float32(time_index * b_local)
    b_idx = float(b0) + torch.arange(b_local, dtype=torch.float32,
                                     device=x.device)
    theta = -ang[:, None] * b_idx[None, :]
    x = x.to(torch.float32)
    yr, yi = channelize_matmul(x[:, 0].reshape(b_local, p_in),
                               x[:, 1].reshape(b_local, p_in), lo_r, lo_i,
                               torch.cos(theta), torch.sin(theta), a)
    return torch.stack([yr, yi], dim=-1)


def packed_decode_step(max_candidates: int, max_symbols: int, max_out: int):
    """The sharded decode body shared by the single-host and multi-host
    decoders: step(mesh, shards, left_edges, right_edges), with
    shards[ci][tj] the local (C_local, T_local, 2) decimated block on
    mesh.devices[ci][tj], exchanges halos along "time" and decodes every
    shard with the defaults of the JAX shard body (sync "xla": the sync
    kernel's stream mode, then the four-branch filter and the flat
    demod).  Returns each shard's packed rows on its device, chan-major,
    with the global chan and t0 in the row meta.  left_edges[ci] /
    right_edges[ci] are a row's halos from the neighbouring processes."""
    right = burst_window(max_symbols)

    def step(mesh: Mesh, shards: list, left_edges=None, right_edges=None):
        bufs = []
        for ci, row in enumerate(shards):
            c_local, t_local = row[0].shape[:2]
            exts = halo_exchange(
                row, HALO_LEFT, right,
                None if left_edges is None else left_edges[ci],
                None if right_edges is None else right_edges[ci])
            for tj, y_ext in enumerate(exts):
                buf = device_decode_packed(
                    y_ext, max_candidates, max_symbols, max_out,
                    chan_base=ci * c_local, core_start=HALO_LEFT,
                    core_len=t_local, sync_impl="xla")
                bufs.append(globalize_t0(
                    buf, (mesh.time_start + tj) * t_local))
        return bufs

    return step


def raw_decode_step(max_candidates: int, max_symbols: int, max_out: int,
                    p_in: int):
    """Sharded decode from raw planes: step(mesh, x_shards, consts,
    period0) channelizes each shard on its device (x_shards[ci][tj]
    (T_raw_local, 2), consts[ci][tj] its (lo_r, lo_i, a, ang); period-
    aligned raw input needs no halo), then runs packed_decode_step: no
    decimated sample passes through the host."""
    inner = packed_decode_step(max_candidates, max_symbols, max_out)

    def step(mesh: Mesh, x_shards: list, consts: list, period0):
        y = [[channelize_shard(x, *consts[ci][tj], p_in, period0,
                               mesh.time_start + tj)
              for tj, x in enumerate(row)] for ci, row in enumerate(x_shards)]
        return inner(mesh, y)

    return step


def fetch_rows(bufs: list) -> np.ndarray:
    """The host's one fetch: every shard's packed rows, concatenated on
    the first shard's device in the order given, as one numpy buffer."""
    dev = bufs[0].device
    return torch.cat([copy_to(b, dev) for b in bufs]).cpu().numpy()


def _planes(v) -> torch.Tensor:
    """Complex host samples, or (..., 2) re/im planes (numpy or torch) ->
    a float32 tensor of planes where the input lives."""
    if isinstance(v, np.ndarray) and np.iscomplexobj(v):
        v = pack_complex(v)
    return torch.as_tensor(v, dtype=torch.float32)


def shard_channels(mesh: Mesh, y) -> list:
    """(C, T) complex or (C, T, 2) decimated streams -> shards[ci][tj] on
    mesh.devices[ci][tj]; C must divide over the chan axis and T over the
    (local) time axis."""
    y = _planes(y)
    n_chan, n_time = mesh.shape
    c, t = y.shape[:2]
    if c % n_chan or t % n_time:
        raise ValueError(f"a ({c}, {t}) block does not divide over a "
                         f"{n_chan} x {n_time} mesh")
    cl, tl = c // n_chan, t // n_time
    return [[copy_to(y[ci * cl:(ci + 1) * cl, tj * tl:(tj + 1) * tl],
                     mesh.devices[ci][tj]).contiguous()
             for tj in range(n_time)] for ci in range(n_chan)]


def shard_raw(mesh: Mesh, x, p_in: int) -> list:
    """(T_raw,) complex samples or (T_raw, 2) planes -> x_shards[ci][tj]:
    time block tj, whole periods, on every device of its column."""
    x = _planes(x)
    n_chan, n_time = mesh.shape
    t = x.shape[0]
    if t % (n_time * p_in):
        raise ValueError(f"{t} raw samples do not divide into {n_time} "
                         f"shards of whole {p_in}-sample periods")
    tl = t // n_time
    return [[copy_to(x[tj * tl:(tj + 1) * tl], mesh.devices[ci][tj])
             for tj in range(n_time)] for ci in range(n_chan)]


def raw_constants(mesh: Mesh, f_offsets, fs: int, sdrclk: int,
                  lo_wrap: bool) -> list:
    """consts[ci][tj] = (lo_r, lo_i, a, ang) of channel slice ci on
    mesh.devices[ci][tj]: the base LO over one period, the aggregation
    matrix, and the LO's angle per period (0 with the wrapped table)."""
    n_chan, n_time = mesh.shape
    if len(f_offsets) % n_chan:
        raise ValueError(f"{len(f_offsets)} channels do not divide over "
                         f"{n_chan} chan shards")
    p_in, _ = period_for(sdrclk)
    fo = tuple(float(f) for f in f_offsets)
    lo, _ = lo_tables(fo, fs, sdrclk, lo_wrap)
    ang = (np.zeros(len(fo)) if lo_wrap
           else 2.0 * np.pi * np.asarray(fo) * (p_in / fs))
    host = (lo.real.astype(np.float32), lo.imag.astype(np.float32),
            ang.astype(np.float32))
    a = aggregation_matrix(sdrclk)
    cl = len(fo) // n_chan
    consts = []
    for ci in range(n_chan):
        sl = slice(ci * cl, (ci + 1) * cl)
        lo_r, lo_i, ang_c = (np.ascontiguousarray(v[sl]) for v in host)
        consts.append([
            tuple(torch.from_numpy(v).to(mesh.devices[ci][tj])
                  for v in (lo_r, lo_i, a, ang_c))
            for tj in range(n_time)])
    return consts


@dataclass
class ShardedWidebandDecoder:
    """Full sharded step: raw wideband IQ -> channelize -> decode.

    The raw input (T_raw,) is cut over the "time" axis on channelizer-
    period boundaries (4*sdrclk samples), so channelization is local; the
    per-channel 84 kHz streams then exchange halos and run the decode
    stages, with channels cut over "chan".  Each shard compacts its
    candidates on its device into packed rows (pipeline.
    device_decode_packed), and the host fetches one (n_shards * max_out,
    2096) buffer."""
    mesh: Mesh
    f_offsets: tuple
    fs: int = 2_000_000
    sdrclk: int = 500
    lo_wrap: bool = True
    max_candidates: int = 4
    max_symbols: int = 256
    max_out: int = 64              # packed decode slots per shard

    def __post_init__(self):
        set_f32_matmul()
        self.p_in, self.p_out = period_for(self.sdrclk)
        self._consts = raw_constants(self.mesh, self.f_offsets, self.fs,
                                     self.sdrclk, self.lo_wrap)
        self._step = raw_decode_step(self.max_candidates, self.max_symbols,
                                     self.max_out, self.p_in)

    def decode(self, x, observer=None) -> list:
        bufs = self._step(self.mesh, shard_raw(self.mesh, x, self.p_in),
                          self._consts, 0.0)
        buf = fetch_rows(bufs)
        if observer is not None:        # stage counters + overflow warning
            observer(buf)
        return unpack_results(buf)


@dataclass
class ShardedDecoder:
    """Sharded decode step over a (chan, time) mesh.

    decode(y): y is a global (C, T) complex array or (C, T, 2) planes
    (numpy or torch) of decimated 84 kHz streams; C divisible by the
    mesh's chan size, T by its time size.  Each shard runs the early-
    compaction packed decode and the host does one fetch; returns the
    candidate dicts with global chan and t0."""
    mesh: Mesh
    max_candidates: int = 8
    max_symbols: int = 1024
    max_out: int = 64

    def __post_init__(self):
        set_f32_matmul()
        self._step = packed_decode_step(self.max_candidates,
                                        self.max_symbols, self.max_out)

    def decode(self, y, observer=None) -> list:
        buf = fetch_rows(self._step(self.mesh, shard_channels(self.mesh, y)))
        if observer is not None:        # stage counters + overflow warning
            observer(buf)
        return unpack_results(buf)
