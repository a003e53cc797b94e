"""End-to-end decode: raw wideband IQ -> decoded AVLC frames.

Device stages (PyTorch on the pipeline's device):
  ingest of the capture's native samples (cu8, cs16, cf32, f32real), or
  of complex samples -> channelizer (residue-space "dft", dense
  "matmul", its FIR form, filterbank "pfb", or with use_pallas the fused
  u8 channelizer: a CUDA kernel on a card) -> sync scan (CUDA kernel on
  a card) -> trigger extraction -> q-ranked slot compaction -> burst
  demod -> header trellis -> block assembly -> RS(255,249) -> packed rows
Host stages:
  unpack -> greedy first-trigger-wins overlap filter -> HDLC deframe +
  CRC (native C++ when built) -> frame decoder.

Entry points, as the JAX package's Pipeline: decode_wideband_u8 and
stream_wideband_u8 (native raw samples in one device program per
block), decode_wideband / decode_channels / stream_wideband /
stream_channels (complex samples or decimated streams), and stream_live
(a pipe).  Long captures stream in overlapping blocks; a candidate is
owned by the block whose core region holds its trigger.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ._tables import (
    HALO_LEFT,
    MAX_TX_BYTES,
    RAW_FMT,
    DecodedBurst,
    PipelineConfig,
    burst_span_samples,
    packed_stats,
    resolve_chan_impl,
    right_margin,
    stream_geometry,
    unpack_results,
)
from .constants import DEMOD_RATE, RS_K
from .golden.codec import Unstuffer, frame_crc_ok
from .host.native import deframe_block_native
from .io.live import RawReader, stream_blocks
from .io.sdr import choose_fc
from .metrics import timed
from .ops.assembly import assemble_blocks
from .ops.channelizer import Channelizer, set_f32_matmul
from .ops.demod import (
    demod_candidates_flat,
    demod_candidates_inline,
    find_triggers,
    pack_complex,
    polyphase_filter,
)
from .ops.header import header_decode
from .ops.ingest import raw_to_planes, raw_to_planes_split
from .ops.rs_fec import rs_decode_rows
from .ops.sync import sync_scan

TWO_PI = 2.0 * math.pi

# "xla" materializes the four-branch filter output and demodulates from
# it; its sync metric is "stream"'s (branch 0 of the same filter)
SYNC_IMPLS = ("xla", "stream", "fused")

# the device program's stages, in order, as its mark argument names them
# ("channelize" is wideband_raw_decode's; the rest device_decode_packed's)
STAGES = ("channelize", "sync", "triggers", "compaction", "demod", "header",
          "assembly", "rs", "pack")


def _no_mark(stage: str) -> None:
    pass


def device_decode_packed(y: torch.Tensor, max_candidates: int,
                         max_symbols: int, max_out: int, chan_base: int = 0,
                         core_start: int = 0, core_len: int = 0,
                         sync_impl: str = "stream", mark=None) -> torch.Tensor:
    """(C, T, 2) decimated streams -> (M, 2096) uint8 packed rows, one per
    decode slot (layout in _tables.PACKED_ROW_BYTES).

    Trigger slots (C, K) compact to the max_out best by sync quality q
    BEFORE the per-candidate stages, so demod, header, assembly and RS
    scale with max_out.  core_start/core_len (streaming): only triggers
    inside the core region are owned, and t0 comes back core-relative.
    chan_base (a mesh shard's first global channel) is added to the
    packed chan word.  compute does not enter here: bf16 applies to the
    channelizer only.  mark (measurement only: stage_times.py) is called
    with a stage's name (STAGES) where that stage's work has been
    enqueued; it changes nothing of what runs."""
    if sync_impl not in SYNC_IMPLS:
        raise ValueError(f"sync_impl must be one of {SYNC_IMPLS}, "
                         f"got {sync_impl!r}")
    dev = y.device
    if mark is None:
        mark = _no_mark
    err, fr = sync_scan(y, "stream" if sync_impl == "xla" else sync_impl)
    mark("sync")
    t0, of, df, valid, q = find_triggers(err, fr, max_candidates)
    if core_len:
        valid = valid & (t0 >= core_start) & (t0 < core_start + core_len)
    mark("triggers")

    c, k = t0.shape
    n = c * k
    m = min(max_out, n)
    # compact by SYNC QUALITY: under slot pressure real preambles (q well
    # below the 4.0 threshold) keep their slots and junk triggers (q near
    # 4.0) drop; a stable sort keeps equal keys in trigger order
    key = torch.where(valid.reshape(n), q.reshape(n),
                      torch.full_like(q.reshape(n), math.inf))
    order = torch.argsort(key, stable=True)[:m]
    chan = order // k
    t0s = t0.reshape(n)[order]
    ofs = of.reshape(n)[order]
    dfs = df.reshape(n)[order]
    live = valid.reshape(n)[order]
    mark("compaction")

    if sync_impl == "xla":
        soft = demod_candidates_flat(y, chan, t0s, ofs, dfs, max_symbols,
                                     polyphase_filter(y))
    else:
        soft = demod_candidates_inline(y, chan, t0s, ofs, dfs, max_symbols)
    mark("demod")
    length, nbrow, nlbyte, ok = header_decode(soft[:, :25])
    mark("header")
    need = 8 * MAX_TX_BYTES
    data_soft = soft[:, 25:25 + need]
    if data_soft.shape[1] < need:
        data_soft = torch.nn.functional.pad(
            data_soft, (0, need - data_soft.shape[1]))
    blocks, consumed = assemble_blocks(data_soft, nbrow, nlbyte)
    mark("assembly")

    rows = blocks.reshape(m * 8, 255)
    is_last = torch.arange(8, device=dev)[None, :] == (nbrow[:, None] - 1)
    cls_last = torch.where(nlbyte[:, None] <= 30, 2,
                           torch.where(nlbyte[:, None] <= 67, 1, 0))
    eras_class = torch.where(is_last, cls_last, 0).reshape(-1)
    fixed, counts = rs_decode_rows(rows, eras_class)
    mark("rs")

    # block-wide counters ride in row 0 only, so buffers of several
    # blocks or shards concatenate and still sum correctly
    n_sync_valid = valid.to(torch.int32).sum()
    n_header_reject = (live & ~ok).to(torch.int32).sum()
    first = (torch.arange(m, device=dev) == 0).to(torch.int32)
    live = live & ok
    i32 = torch.int32
    meta = torch.stack([
        chan.to(i32) + chan_base,
        (t0s - core_start).to(i32),
        length.to(i32),
        nbrow.to(i32),
        nlbyte.to(i32),
        consumed.to(i32),
        live.to(i32),
        ofs.to(torch.float32).contiguous().view(i32),
        dfs.to(torch.float32).contiguous().view(i32),
        first * n_sync_valid,
        first * n_header_reject,
        first * torch.clamp(n_sync_valid - m, min=0),
    ], dim=1)
    meta_u8 = meta.contiguous().view(torch.uint8).reshape(m, 48)
    rs8 = (counts.reshape(m, 8) + 1).to(torch.uint8)
    packed = torch.cat([fixed.reshape(m, 8 * 255), rs8, meta_u8], dim=1)
    mark("pack")
    return packed


def channelize_raw(raw: torch.Tensor, ch: Channelizer, fmt: str,
                   use_pallas: bool) -> torch.Tensor:
    """Native raw samples (on the device, whole periods) -> (C, T, 2)
    decimated streams, routed by the channelizer's impl.

    use_pallas (cu8 and the matmul channelizer only) runs the fused u8
    channelizer on the raw bytes.  Otherwise the capture converts to
    planes, split-phase for cu8 into the residue-space channelizers and
    in sample order for everything else, through the channelizer's
    compute mode.  Either way the channelizer advances its period cursor
    by the block."""
    if use_pallas:
        if fmt != "cu8":
            raise ValueError("the fused u8 channelizer takes cu8 only")
        return ch.forward_u8(raw)
    split = fmt == "cu8" and ch.impl != "matmul"
    if split:
        x_r, x_i = raw_to_planes_split(raw, ch.p_in)
    else:
        x_r, x_i = raw_to_planes(raw, fmt, ch.p_in)
    return ch(x_r, x_i, split=split)


def wideband_raw_decode(raw: torch.Tensor, ch: Channelizer, fmt: str,
                        use_pallas: bool, max_candidates: int,
                        max_symbols: int, max_out: int, core_start: int = 0,
                        core_len: int = 0,
                        sync_impl: str = "stream", mark=None) -> torch.Tensor:
    """Native raw samples (on the device, whole periods) -> packed rows:
    the JAX package's fused device programs _wideband_u8_decode,
    _wideband_raw_decode_dft and _wideband_raw_decode_pfb
    (vdlm2dec_tpu/pipeline.py:344-475): channelize_raw, then
    device_decode_packed.  mark as in device_decode_packed."""
    y = channelize_raw(raw, ch, fmt, use_pallas)
    if mark is not None:
        mark("channelize")
    return device_decode_packed(y, max_candidates, max_symbols, max_out,
                                core_start=core_start, core_len=core_len,
                                sync_impl=sync_impl, mark=mark)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    return host.to(device)


class _BlockPlan:
    """The cut of a fused stream (stream_wideband_u8, _stream_live_fused)
    into overlapping raw segments, addressed by absolute position in the
    capture's native items: block i's segment is a left margin, a core of
    core_p periods and a right margin.  Under use_pallas a segment is
    whole 32-period tiles, as in the JAX package: the longer right margin
    can change which triggers win a channel's candidate slots, so the
    packed rows follow it.  stream_geometry is looked up when a stream
    starts."""

    def __init__(self, pipe: "Pipeline", fmt: str, block_seconds: float):
        ch, cfg = pipe.channelizer, pipe.cfg
        self.per, self.pad_val = RAW_FMT[fmt]
        self.lmarg_p, _rmarg_p, self.core_p, self.total_p = stream_geometry(
            ch.p_in, ch.p_out, cfg.fs, cfg.max_symbols, block_seconds,
            align=32 if cfg.use_pallas else 1)
        self.p_out = ch.p_out
        self.lmarg_dec = self.lmarg_p * ch.p_out
        self.core_dec = self.core_p * ch.p_out
        self.items_p = ch.p_in * self.per        # raw items per period

    def bounds(self, i: int) -> tuple[int, int]:
        """[lo, hi) of block i's segment in raw items (lo < 0 for block 0:
        its left margin precedes the capture)."""
        lo = (i * self.core_p - self.lmarg_p) * self.items_p
        return lo, lo + self.total_p * self.items_p

    def segment(self, raw: np.ndarray, i: int) -> np.ndarray:
        """Block i's segment of the whole capture raw, padded beyond the
        capture's whole samples with the format's neutral value."""
        lo, hi = self.bounds(i)
        seg = np.full(hi - lo, self.pad_val, dtype=raw.dtype)
        s_lo, s_hi = max(lo, 0), min(hi, len(raw) - len(raw) % self.per)
        if s_hi > s_lo:
            seg[s_lo - lo: s_hi - lo] = raw[s_lo:s_hi]
        return seg

    def n_blocks(self, items: int) -> int:
        """Blocks of a capture of `items` raw items: each whose core holds
        a whole sample."""
        return -(-(items - items % self.per) // (self.core_p * self.items_p))

    def owned(self, i: int, items: int) -> int:
        """Decimated samples of each channel that block i owns in a capture
        of `items` raw items: its core, up to the last whole period."""
        total_dec = items // self.items_p * self.p_out
        return max(0, min(self.core_dec, total_dec - i * self.core_dec))


class Pipeline:
    """Decoder for one channel plan on one device.  device is where the
    device stages run: a CUDA device uses the hand-written kernels (sync
    scan, and the fused u8 channelizer under use_pallas), the CPU their
    plain PyTorch versions."""

    def __init__(self, cfg: PipelineConfig, device):
        # resolve auto fields into a private copy; the caller's cfg keeps
        # its declared intent
        cfg = dataclasses.replace(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.metrics = None              # optional PipelineMetrics sink
        self.spans = None                # optional metrics.SpanLog
        self._overflow_warned = False
        self._metrics_lock = threading.Lock()
        self.sdrclk = cfg.resolved_sdrclk()
        if cfg.sync_impl not in SYNC_IMPLS:
            raise ValueError(f"sync_impl must be one of {SYNC_IMPLS}")
        set_f32_matmul()
        if cfg.fc_hz is None:
            cfg.fc_hz = choose_fc([int(f) for f in cfg.freqs_hz], cfg.fs)
        # an airspy real capture is mixed relative to F0 = Fc + fs/4
        # (air.c:182-185)
        f0 = cfg.fc_hz + cfg.fs / 4 if cfg.real_input else cfg.fc_hz
        self.f_offsets = [f - f0 for f in cfg.freqs_hz]
        if cfg.chan_impl == "auto":
            cfg.chan_impl = resolve_chan_impl(
                self.f_offsets, cfg.fs, self.sdrclk, cfg.lo_wrap,
                cfg.filter_mode, cfg.use_pallas)
        if cfg.use_pallas and cfg.chan_impl in ("dft", "pfb"):
            raise ValueError("use_pallas applies to the dense matmul "
                             "channelizer only")
        self.channelizer = Channelizer(
            self.f_offsets, fs=cfg.fs, sdrclk=self.sdrclk,
            lo_wrap=cfg.lo_wrap, impl=cfg.chan_impl, device=self.device,
            real_input=cfg.real_input, filter_mode=cfg.filter_mode,
            compute=cfg.compute)
        # a mesh shards decode_channels (hence decode_wideband); the
        # streaming entry points decode block by block on self.device
        self._sharded = None
        if cfg.mesh is not None:
            from .parallel.sharding import ShardedDecoder

            self._sharded = ShardedDecoder(
                cfg.mesh, max_candidates=cfg.max_candidates,
                max_symbols=cfg.max_symbols)

    def _max_out(self) -> int:
        n = len(self.cfg.freqs_hz) * self.cfg.max_candidates
        if self.cfg.max_out is not None:
            return min(self.cfg.max_out, n)
        return min(n, 512)

    def observe_packed(self, buf: np.ndarray, device_s: float = 0.0) -> None:
        """Fold a packed buffer's stage counters (and device_s, its device
        time) into metrics and warn once on candidate overflow (silent
        frame loss otherwise).  Called from the fetch thread too, hence
        the lock."""
        stats = packed_stats(buf)
        with self._metrics_lock:
            warn = stats["candidates_overflow"] and not self._overflow_warned
            if warn:
                self._overflow_warned = True
            m = self.metrics
            if m is not None:
                m.sync_candidates += stats["sync_candidates"]
                m.bursts_rejected_header += stats["bursts_rejected_header"]
                m.candidates_overflow += stats["candidates_overflow"]
                m.device_time_s += device_s
        if warn:
            print(f"vdlm2t: WARNING: {stats['candidates_overflow']} sync "
                  f"candidates dropped: decode slots exhausted "
                  f"(max_out={self._max_out()}); raise max_out/max_candidates",
                  file=sys.stderr)

    # -- complex samples and decimated streams -------------------------------
    def decode_wideband(self, x) -> list[DecodedBurst]:
        """A whole capture of complex (or, under real_input, real)
        samples, zero-padded to whole periods -> decoded bursts, through
        the channelizer's sample entry and the period cursor."""
        p_in = self.channelizer.p_in
        t = len(x)
        if t % p_in:
            x = np.pad(np.asarray(x), (0, p_in - t % p_in))
        return self.decode_channels(self.channelizer.channelize(x))

    def decode_channels(self, y) -> list[DecodedBurst]:
        """y: (C, T) complex or (C, T, 2) re/im decimated 84 kHz streams,
        numpy or torch -> decoded bursts, as one block."""
        if isinstance(y, np.ndarray) and np.iscomplexobj(y):
            y = pack_complex(y)
        if self.metrics is not None:
            self.metrics.decimated_samples += int(y.shape[0] * y.shape[1])
        if self._sharded is not None:
            cands = self._sharded.decode(y, observer=self.observe_packed)
        else:
            cands = self._decode_block(y)
        return self._finish(cands, t_offset=0)

    def _decode_block(self, y, core_start: int = 0,
                      core_len: int = 0) -> list[dict]:
        """(C, T, 2) decimated streams -> live candidate dicts, in one
        device program and one fetch.  core_start/core_len restrict
        ownership to the core region; t0 then returns core-relative."""
        t_start = time.perf_counter()
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        return self._collect(t_start, device_decode_packed(
            y.contiguous(), self.cfg.max_candidates, self.cfg.max_symbols,
            self._max_out(), core_start=core_start, core_len=core_len,
            sync_impl=self.cfg.sync_impl))

    def _collect(self, t_start: float, packed: torch.Tensor) -> list[dict]:
        """Fetch a block's packed rows, observe them with the time since
        t_start, and unpack the live candidates."""
        buf = packed.cpu().numpy()
        self.observe_packed(buf, time.perf_counter() - t_start)
        return unpack_results(buf)

    # -- native raw samples: one device program per block ---------------------
    def decode_wideband_u8(self, raw: np.ndarray, fmt: str = "cu8",
                           core_start: int = 0,
                           core_len: int = 0) -> list[dict]:
        """Raw capture in its native format -> live candidate dicts, in
        one device program and one fetch.  core_start/core_len restrict
        ownership to the core region; t0 then returns core-relative.
        Consecutive calls continue the LO phase (lo_wrap=False) from the
        period cursor."""
        t_start = time.perf_counter()
        return self._collect(t_start, self.dispatch_fused(raw, fmt, core_start,
                                                          core_len))

    def dispatch_fused(self, raw: np.ndarray, fmt: str, core_start: int,
                       core_len: int, block: int | None = None
                       ) -> torch.Tensor:
        """Enqueue one raw block (shared by decode_wideband_u8 and
        PipelinedDecoder): trim to whole periods (to 32-period tiles under
        use_pallas, as the JAX package does), run the device program, which
        advances the period cursor.  Returns the packed rows on the device.
        The fused program is boxcar-only, as in the JAX package.  block (the
        block's SpanLog number, while self.spans is on) records the upload
        and each stage's enqueue as children of block.dispatch."""
        ch, cfg = self.channelizer, self.cfg
        if cfg.filter_mode != "boxcar":
            raise ValueError("the fused device program is boxcar-only; use "
                             "stream_wideband for filter_mode='fir'")
        per, _pad = RAW_FMT[fmt]
        t = len(raw) // per
        t -= t % (ch.p_in * (32 if cfg.use_pallas else 1))
        spans = None if block is None else self.spans
        with timed(spans, "block.upload", block, "block.dispatch"):
            raw_dev = _to_device(raw[: per * t], self.device)
            if self.metrics is not None:
                with self._metrics_lock:
                    self.metrics.h2d_bytes += raw_dev.nbytes
        return wideband_raw_decode(
            raw_dev, ch, fmt, cfg.use_pallas,
            cfg.max_candidates, cfg.max_symbols, self._max_out(), core_start,
            core_len, sync_impl=cfg.sync_impl,
            mark=None if spans is None else spans.marker(block,
                                                         "block.dispatch"))

    def fused_route(self, fmt: str) -> bool:
        """Whether a stream of format fmt goes through the fused device
        program (the JAX CLI's fused_ok and stream_live's test): the
        reference LO mode, the boxcar filter, and cu8 if use_pallas (the
        fused u8 channelizer takes cu8 only).  Otherwise it converts on
        the host and enters the channelizer's sample entry.  The CLI
        also takes the host-converted route under --mesh."""
        cfg = self.cfg
        return (cfg.lo_wrap and cfg.filter_mode == "boxcar"
                and (fmt == "cu8" or not cfg.use_pallas))

    def core_raw_samples(self, block_seconds: float) -> int:
        """Raw wideband samples per streaming core block."""
        p_in = self.channelizer.p_in
        return max(1, int(block_seconds * self.cfg.fs) // p_in) * p_in

    def stream_wideband(self, x, block_seconds: float = 4.0,
                        start_block: int = 0,
                        prev_end: dict[int, int] | None = None):
        """Streaming decode of complex samples in fixed overlapping
        blocks: x is a numpy array or an io.sdr.CaptureReader (its read()
        converts a memmap on the host, DC subtracted, and zero-fills
        outside the capture, as the array path does).  Each block's
        segment (core + margins) is channelized at its absolute period
        (period0, so lo_wrap=False stays phase-exact over overlapping
        reads) and decoded on the device.  Any filter and channelizer.

        start_block skips already-decoded blocks exactly (segments are
        addressed by position); prev_end is the per-channel end of the
        last accepted burst, carried across blocks and checkpoints.
        Yields lists of DecodedBurst per block."""
        ch = self.channelizer
        p_in, p_out = ch.p_in, ch.p_out
        lmarg_p, rmarg_p, core_p, _ = stream_geometry(
            p_in, p_out, self.cfg.fs, self.cfg.max_symbols, block_seconds)
        lmarg_dec, core_dec = lmarg_p * p_out, core_p * p_out
        t = len(x)
        n_core = -(-t // (core_p * p_in))
        total_dec = (t // p_in) * p_out
        c = len(self.f_offsets)
        if prev_end is None:
            prev_end = {}

        if hasattr(x, "read"):
            read = x.read
        else:
            def read(start: int, n: int) -> np.ndarray:
                s_lo, s_hi = max(start, 0), min(start + n, t)
                if s_lo == start and s_hi == start + n:
                    return x[start: start + n]
                out = np.zeros(n, dtype=x.dtype)
                if s_hi > s_lo:
                    out[s_lo - start: s_hi - start] = x[s_lo:s_hi]
                return out

        spans = self.spans
        for i in range(start_block, n_core):
            block = None if spans is None else spans.new_block()
            lo_p = i * core_p - lmarg_p
            seg = read(lo_p * p_in, (lmarg_p + core_p + rmarg_p) * p_in)
            y = ch.channelize(seg, period0=lo_p)
            with timed(spans, "block.dispatch", block):
                cands = self._decode_block(y, lmarg_dec, core_dec)
            if self.metrics is not None:
                self.metrics.decimated_samples += c * max(
                    0, min(core_dec, total_dec - i * core_dec))
            with timed(spans, "block.finish", block):
                bursts = self._finish(cands, t_offset=i * core_dec,
                                      prev_end=prev_end)
            yield bursts

    def stream_wideband_u8(self, raw: np.ndarray, block_seconds: float = 2.0,
                           start_block: int = 0,
                           prev_end: dict[int, int] | None = None,
                           fmt: str = "cu8"):
        """Streaming decode of a capture in its native format (may be a
        np.memmap): fixed overlapping raw blocks addressed by absolute
        position, each one device program and one fetch, overlapped
        through PipelinedDecoder.  Requires lo_wrap=True (the reference's
        LO mode): the device program is then block-position independent.
        start_block and prev_end resume as in stream_wideband (pass the
        checkpointed prev_end to restore cross-block burst suppression).
        Yields lists of DecodedBurst per block.  While self.spans is on,
        each block records block.segment, the spans of
        PipelinedDecoder.submit and its fetch, and block.finish."""
        if not self.cfg.lo_wrap:
            raise ValueError("fused streaming requires lo_wrap=True")
        plan = _BlockPlan(self, fmt, block_seconds)
        if prev_end is None:
            prev_end = {}               # per channel: end of the last burst
        pending: list[tuple] = []                # (i, block) FIFO
        spans = self.spans
        pd = PipelinedDecoder(self, fmt=fmt, core_start=plan.lmarg_dec,
                              core_len=plan.core_dec)
        try:
            for i in range(start_block, plan.n_blocks(len(raw))):
                block = None if spans is None else spans.new_block()
                with timed(spans, "block.segment", block):
                    seg = plan.segment(raw, i)
                pending.append((i, block))
                for cands in pd.submit(seg, block):
                    yield self._finish_block(plan, cands, *pending.pop(0),
                                             len(raw), prev_end)
            for cands in pd.drain():
                yield self._finish_block(plan, cands, *pending.pop(0),
                                         len(raw), prev_end)
        finally:
            pd.close()          # even when the generator is abandoned

    def stream_live(self, source, fmt: str = "cu8",
                    block_seconds: float = 2.0):
        """Incremental decode of a pipe or growing stream (rtl_sdr | ...):
        source is "-" (stdin), a path or a binary file object.  Yields
        lists of DecodedBurst as each core block completes.  On the
        fused route (fused_route) the blocks go through the fused device
        program (_stream_live_fused); otherwise the stream converts on the
        host
        (io.live.stream_blocks), channelizes block by block from the
        period cursor and decodes from a rolling window of decimated
        streams with a 160-sample left and one-burst right margin."""
        if self.fused_route(fmt):
            yield from self._stream_live_fused(source, fmt, block_seconds)
            return
        ch = self.channelizer
        p_in = ch.p_in
        raw_per_block = max(p_in,
                            int(block_seconds * self.cfg.fs) // p_in * p_in)
        lmargin = HALO_LEFT
        rmargin = right_margin(self.cfg.max_symbols)
        core = raw_per_block // p_in * ch.p_out
        span = lmargin + core + rmargin
        c = len(self.f_offsets)
        tail = torch.zeros((c, 0, 2), device=self.device)
        base = 0                       # global index of tail[:, 0]
        prev_end = {ci: -1 for ci in range(c)}
        spans = self.spans

        def decode(seg, base):
            block = None if spans is None else spans.new_block()
            with timed(spans, "block.dispatch", block):
                cands = self._decode_block(seg, lmargin, core)
            with timed(spans, "block.finish", block):
                return self._finish(cands, t_offset=base + lmargin,
                                    prev_end=prev_end)

        for x in stream_blocks(source, fmt, raw_per_block):
            buf = torch.cat([tail, ch.channelize(x[:raw_per_block])], dim=1)
            while buf.shape[1] >= span:
                yield decode(buf[:, :span], base)
                buf = buf[:, core:]
                base += core
            tail = buf
        # EOF: zero-pad what is left past the left margin to one segment
        if tail.shape[1] > lmargin:
            yield decode(F.pad(tail, (0, 0, 0, span - tail.shape[1])), base)

    def _stream_live_fused(self, source, fmt: str, block_seconds: float):
        """Live decode through the fused device program: a rolling raw
        window in the native dtype feeds the same overlapping segments as
        stream_wideband_u8.  Each read asks for what the next segment
        lacks (the first core and its right margin, then one core a
        block), so a block is dispatched as soon as its margin is in, and
        its result is waited for and yielded before the next read
        (PipelinedDecoder.wait_all; PipelineMetrics.live_result_wait_s
        and live_blocks count that wait).  Memory is bounded by one
        segment whatever the stream's length; at EOF the right margin is
        padded with the format's neutral value so every block that was fed
        decodes, and only the items actually read count towards
        decimated_samples.  While self.spans is on, each block records
        block.read (the wait for its segment's end), block.segment, the
        spans of PipelinedDecoder.submit and its fetch, and block.finish."""
        plan = _BlockPlan(self, fmt, block_seconds)
        reader = RawReader(source, fmt)
        # a block is fed once a byte of its core has been read
        core_bytes = plan.core_p * plan.items_p * reader.dtype.itemsize

        # rolling window: starts with the zero-history left margin
        win_base = plan.bounds(0)[0]         # absolute item index of win[0]
        win = np.full(-win_base, plan.pad_val, dtype=reader.dtype)
        prev_end: dict[int, int] = {}
        spans, metrics = self.spans, self.metrics
        pd = PipelinedDecoder(self, fmt=fmt, core_start=plan.lmarg_dec,
                              core_len=plan.core_dec)
        try:
            i = 0
            while True:
                seg_lo, seg_hi = plan.bounds(i)
                block = None
                t_seg = time.monotonic_ns()
                if not reader.eof:
                    if spans is not None:
                        block = spans.new_block()
                    t_read = time.monotonic_ns()
                    raw = reader.read(seg_hi - (win_base + len(win)))
                    t_seg = time.monotonic_ns()
                    if spans is not None:
                        spans.add("block.read", block, t_read, t_seg)
                    win = np.concatenate([win, raw])
                if reader.eof:
                    # EOF: pad the right margin so every fed block decodes
                    if i * core_bytes >= reader.nbytes:
                        break
                    need = seg_hi - (win_base + len(win))
                    if need > 0:
                        win = np.concatenate([win, np.full(
                            need, plan.pad_val, dtype=reader.dtype)])
                seg = win[seg_lo - win_base: seg_hi - win_base]
                if spans is not None:
                    if block is None:
                        block = spans.new_block()
                    # from the read's return through the window's
                    # concatenate and slice
                    spans.add("block.segment", block, t_seg,
                              time.monotonic_ns())
                done = list(pd.submit(seg, block))
                t_wait = time.perf_counter()
                done += pd.wait_all()
                if metrics is not None:
                    metrics.live_result_wait_s += time.perf_counter() - t_wait
                    metrics.live_blocks += 1
                (cands,) = done
                yield self._finish_block(plan, cands, i, block, reader.items,
                                         prev_end)
                i += 1
                keep_from = plan.bounds(i)[0]
                win = win[keep_from - win_base:]
                win_base = keep_from
        finally:
            pd.close()          # even when the generator is abandoned
            reader.close()

    def stream_channels(self, y, core_len: int | None = None):
        """Streaming decode of decimated streams y ((C, T) complex or
        (C, T, 2) re/im, numpy or torch) in core blocks of core_len
        samples (default: 4 s, at least 0.1 s) with zero-filled margins.
        Yields lists of DecodedBurst per block."""
        if isinstance(y, np.ndarray) and np.iscomplexobj(y):
            y = pack_complex(y)
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        c, t = y.shape[:2]
        lmargin = HALO_LEFT
        rmargin = right_margin(self.cfg.max_symbols)
        if core_len is None:
            core_len = max(8400, min(t, 4 * 84000))
        prev_end = {ci: -1 for ci in range(c)}
        for i in range(0, t, core_len):
            seg = y.new_zeros((c, lmargin + core_len + rmargin, 2))
            lo = i - lmargin
            src_lo, src_hi = max(lo, 0), min(i + core_len + rmargin, t)
            seg[:, src_lo - lo: src_hi - lo] = y[:, src_lo:src_hi]
            # ownership (trigger inside the core region) enforced on device
            cands = self._decode_block(seg, lmargin, core_len)
            if self.metrics is not None:
                self.metrics.decimated_samples += c * min(core_len, t - i)
            yield self._finish(cands, t_offset=i, prev_end=prev_end)

    def _finish_block(self, plan: _BlockPlan, cands: list[dict], i: int,
                      block: int | None, items: int,
                      prev_end: dict[int, int]) -> list[DecodedBurst]:
        """Block i of a fused stream over a capture of `items` raw items:
        count the decimated samples it owns, then _finish under
        block.finish."""
        if self.metrics is not None:
            self.metrics.decimated_samples += len(self.f_offsets) * plan.owned(
                i, items)
        with timed(None if block is None else self.spans, "block.finish",
                   block):
            return self._finish(cands, t_offset=i * plan.core_dec,
                                prev_end=prev_end)

    def _finish(self, cands: list[dict], t_offset: int,
                prev_end: dict[int, int] | None = None) -> list[DecodedBurst]:
        """Greedy first-trigger-wins over time-sorted candidates, then HDLC
        deframe (the serial reference suspends sync search during a
        burst, so later triggers inside an accepted span are dropped)."""
        bursts: list[DecodedBurst] = []
        if prev_end is None:
            prev_end = {}
        for cd in sorted(cands, key=lambda d: (d["chan"], d["t0"])):
            ci = cd["chan"]
            t0 = cd["t0"] + t_offset          # global index
            if t0 <= prev_end.get(ci, -1):
                continue
            span = burst_span_samples(cd["consumed"], cd["of"])
            nbrow, nlbyte = cd["nbrow"], cd["nlbyte"]
            block = cd["block"][:nbrow]
            fr_hz = self.cfg.freqs_hz[ci] if ci < len(self.cfg.freqs_hz) else 0.0
            ppm = 10500.0 * cd["df"] / (TWO_PI * fr_hz) * 1e6 if fr_hz else 0.0
            burst = DecodedBurst(
                channel=ci, t0=t0, time_s=t0 / DEMOD_RATE, freq_hz=fr_hz,
                ppm=ppm, length_bits=cd["length"], nbrow=nbrow,
                nlbyte=nlbyte, block=block,
                rs_counts=[int(v) for v in cd["rs_counts"][:nbrow]],
            )
            burst.frames = deframe_corrected(block, nbrow, nlbyte)
            # only a burst with a CRC-valid frame occupies its span: a
            # 0-frame decode is almost always a junk trigger whose chaotic
            # header length would otherwise block the channel and swallow
            # real bursts behind it (PARITY.md divergence 1)
            if burst.frames:
                prev_end[ci] = t0 + span
            bursts.append(burst)
        return bursts


class PipelinedDecoder:
    """Overlapped dispatch and fetch for the fused streaming routes.

    submit() enqueues a block's device program (Pipeline.dispatch_fused)
    and, on a CUDA device, an asynchronous copy of its packed rows into
    pinned host memory (a buffer of its own, alive until the fetch thread
    has unpacked it) between two timing events; one fetch thread takes
    the blocks in turn, waits on each one's last event and unpacks, so the
    host finishes block i while the card runs block i+1.  Up to two blocks
    wait for the fetch thread; submit() blocks on a third.  On the CPU the
    program runs synchronously in submit().  Results come back in
    submission order.

    Spans (while pipe.spans is on and submit() is given the block's
    number): block.dispatch (with block.upload and the stage.* spans of
    dispatch_fused inside), block.queue (the wait for a free place before
    the fetch thread), and on the fetch thread block.unpack and
    block.ready (zero length: the result is handed to the consumer).

    Usage:
        pd = PipelinedDecoder(pipe)
        for raw_block in blocks:
            for cands in pd.submit(raw_block):
                ...
        for cands in pd.drain():
            ...

    The live route, which wants each block out at once rather than the
    overlap, takes every result after each submit() with wait_all().
    """

    def __init__(self, pipe: Pipeline, fmt: str = "cu8", core_start: int = 0,
                 core_len: int = 0):
        self.pipe = pipe
        self.fmt = fmt
        self.core_start = core_start
        self.core_len = core_len
        self._todo = queue.Queue(maxsize=2)    # blocks for the fetch thread
        self._done = queue.Queue()             # their results, in order
        self._pending = 0                      # dispatched, not handed out
        self._stopping = False                 # sentinel posted
        self._thread = threading.Thread(target=self._fetch_loop, daemon=True)
        self._thread.start()

    def _fetch_loop(self):
        while True:
            item = self._todo.get()
            if item is None:
                return
            host, events, t_start, block = item
            spans = None if block is None else self.pipe.spans
            try:
                if events is not None:
                    events[1].synchronize()
                with timed(spans, "block.unpack", block):
                    buf = host.numpy()
                    device_s = (events[0].elapsed_time(events[1]) / 1e3
                                if events is not None
                                else time.perf_counter() - t_start)
                    self.pipe.observe_packed(buf, device_s)
                    r = unpack_results(buf)
            except Exception as e:          # surfaced to the consumer
                r = e
            t_ready = time.monotonic_ns()
            self._done.put(r)
            if spans is not None:
                spans.add("block.ready", block, t_ready, t_ready)

    def _emit_ready(self, wait: bool = False):
        while self._pending:
            try:
                r = self._done.get(block=wait)
            except queue.Empty:
                return
            self._pending -= 1
            if isinstance(r, Exception):
                raise r
            yield r

    def submit(self, raw: np.ndarray, block: int | None = None):
        """Dispatch a block; yields the candidates of blocks already
        fetched, in submission order.  block: the block's SpanLog number,
        for its spans while pipe.spans is on."""
        spans = None if block is None else self.pipe.spans
        t_start = time.perf_counter()
        events = None
        with timed(spans, "block.dispatch", block):
            if self.pipe.device.type == "cuda":
                # on the stream that runs the program and the copy: on
                # cuda:N the argument-free record() would use the current
                # device's stream
                stream = torch.cuda.current_stream(self.pipe.device)
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record(stream)
            dev = self.pipe.dispatch_fused(raw, self.fmt, self.core_start,
                                           self.core_len, block)
            if events is not None:
                host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
                host.copy_(dev, non_blocking=True)
                events[1].record(stream)
            else:
                host = dev
        with timed(spans, "block.queue", block):
            self._todo.put((host, events, t_start, block))
        self._pending += 1
        yield from self._emit_ready(wait=False)

    def _stop(self):
        if not self._stopping:
            self._stopping = True
            self._todo.put(None)

    def close(self):
        """Stop and join the fetch thread; idempotent.  Every exit path
        must reach this (the streaming generators do it in a finally)."""
        self._stop()
        self._thread.join(timeout=300)

    def wait_all(self) -> list:
        """Every result dispatched and not yet handed out, in submission
        order, waiting for each; the fetch thread stays up.  The live route
        calls it after each submit(), so that a block comes out before the
        stream is read on; the file route keeps the overlap of submit() and
        drain()."""
        return list(self._emit_ready(wait=True))

    def drain(self):
        """Yield the remaining results in order, then close."""
        self._stop()
        yield from self._emit_ready(wait=True)
        self.close()


def deframe_corrected(block: np.ndarray, nbrow: int,
                      nlbyte: int) -> list[np.ndarray]:
    """HDLC unstuff + flag scan + CRC over an RS-corrected block, through
    the native C++ deframer when it builds (behaviour-identical to the
    Python path)."""
    frames = deframe_block_native(block, nbrow, nlbyte)
    if frames is not None:
        return frames
    un = Unstuffer()
    for r in range(nbrow):
        by = nlbyte if r == nbrow - 1 else RS_K
        for i in range(by):
            un.push_byte(int(block[r, i]))
    return [f for f in un.frames if frame_crc_ok(f)]
