"""Trigger extraction and per-candidate D8PSK burst demodulation.

find_triggers turns the sync metric into at most K trigger slots per
channel (the reference's perr/p2err hysteresis, d8psk.c:292-305);
demod_candidates_inline demodulates a flat, channel-tagged candidate list
straight from the decimated stream (filteredphase at the recovered timing
phase, differential phase with CFO correction, Gray soft bits and the
descrambler, d8psk.c:211-217 and 314-332).  demod_candidates_flat is the
same demod reading the materialized four-branch filter output of
polyphase_filter (the JAX package's sync_impl="xla" path).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .._tables import EXT_TAPS, GRAY32, GRAY_SOFT, KS, POLY32
from ..constants import SYNC_THRESHOLD
from .sync import PI, TWO_PI

_POLY = [[float(v) for v in row] for row in POLY32]


def pack_complex(x: np.ndarray) -> np.ndarray:
    """Host complex -> (..., 2) float32 re/im planes."""
    return np.stack([np.asarray(x.real, np.float32),
                     np.asarray(x.imag, np.float32)], axis=-1)


def polyphase_filter(y: torch.Tensor) -> torch.Tensor:
    """(C, T, 2) -> (C, 4, T, 2): the 17-tap matched filter at all four
    polyphases; output t filters y[t-16 .. t] (zero history before the
    stream), summed over the taps in ascending order, as JAX's
    polyphase_filter (vdlm2dec_tpu/ops/demod.py:88-112).  Branch 0 is
    ops.sync.polyphase_filter0."""
    t = y.shape[1]
    yp = F.pad(y, (0, 0, 16, 0))
    acc = [None] * 4
    for j in range(17):
        seg = yp[:, j:j + t]
        for phi in range(4):
            term = _POLY[phi][j] * seg
            acc[phi] = term if acc[phi] is None else acc[phi] + term
    return torch.stack(acc, dim=1)


def find_triggers(err: torch.Tensor, fr: torch.Tensor, max_candidates: int,
                  first_valid: int = 150, threshold: float = SYNC_THRESHOLD):
    """Earliest max_candidates trigger positions per channel.

    The metric is evaluated at odd t >= first_valid; a trigger fires where
    the previous metric (t-2) was below threshold and the current one
    rose.  Later local minima within one sync window (137 samples) of a
    trigger are suppressed, as the serial decoder leaves sync search.

    Returns (t0, of, df, valid, q), each (C, K):
      t0  trigger position (clipped to T-1 for empty slots)
      of  parabolic timing offset, quarter-sample units
      df  slope at t0-2: the frequency offset
      valid  slot holds a trigger
      q   the sub-threshold residual at t0-2, the slot's sync quality
    """
    c, t = err.shape
    dev = err.device
    tt = torch.arange(t, device=dev)
    metric_pos = (tt % 2 == 1) & (tt >= first_valid)
    e0 = err
    e1 = F.pad(err, (2, 0))[:, :t]                   # err at t-2
    e2 = F.pad(err, (4, 0))[:, :t]                   # err at t-4
    f1 = F.pad(fr, (2, 0))[:, :t]                    # fr at t-2
    trig = metric_pos[None, :] & (e1 < threshold) & (e0 > e1)
    cnt = torch.cumsum(trig.to(torch.int32), dim=1)
    prev = cnt - trig.to(torch.int32)                # triggers up to t-1
    prev_far = F.pad(cnt, (137, 0))[:, :t]           # triggers up to t-137
    trig = trig & ~((prev - prev_far) > 0)
    # surviving triggers are > 136 apart, so each 128-sample block holds
    # at most one: a per-block min compacts (C, T) to (C, T/128) exactly
    pos = torch.where(trig, tt[None, :], torch.full_like(tt, t + 1)[None, :])
    blk = 128
    nb = -(-t // blk)
    posb = F.pad(pos, (0, nb * blk - t), value=t + 1)
    best = posb.reshape(c, nb, blk).amin(dim=2)
    k_eff = min(max_candidates, nb)
    t0 = torch.sort(best, dim=1).values[:, :k_eff]
    if k_eff < max_candidates:
        t0 = F.pad(t0, (0, max_candidates - k_eff), value=t + 1)
    valid = t0 <= t
    t0c = torch.clamp(t0, max=t - 1)
    ge2 = torch.gather(e2, 1, t0c)
    ge1 = torch.gather(e1, 1, t0c)
    ge0 = torch.gather(e0, 1, t0c)
    df = torch.gather(f1, 1, t0c)
    of = 4.0 * (ge2 - 4.0 * ge1 + 3.0 * ge0) / (ge2 - 2.0 * ge1 + ge0)
    return t0c, of, df, valid, ge1


@functools.lru_cache(maxsize=None)
def _demod_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, device=device)
                 for a in (EXT_TAPS, POLY32, GRAY_SOFT, KS, GRAY32))


def _clk0(of: torch.Tensor) -> torch.Tensor:
    """Rounded timing offset in 0..12; NaN offsets (empty slots: a 0/0
    parabola) count as 0, as XLA's float -> int conversion makes them."""
    return torch.nan_to_num(torch.clamp(torch.floor(of + 0.5), 0, 12),
                            nan=0.0).to(torch.int64)


def _soft_bits(p: torch.Tensor, p1: torch.Tensor, df: torch.Tensor,
               gray: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Symbol phases p (M, ms) and the phase before the first symbol p1
    (M,) -> (M, 3 ms) descrambled soft bits: differential phase minus
    the CFO df, wrapped to [-pi, pi], quantized to a Gray table index."""
    m = p.shape[0]
    pprev = torch.cat([p1[:, None], p[:, :-1]], dim=1)
    d = (p - pprev) - df[:, None]
    d = torch.where(d > PI, d - TWO_PI, d)
    d = torch.where(d < -PI, d + TWO_PI, d)
    # (true division by a 0-dim tensor: CUDA divides by a Python scalar
    # through its reciprocal)
    gi = torch.nan_to_num(
        torch.clamp(torch.floor(128.0 * d / d.new_tensor(PI) + 128.0 + 0.5),
                    0, 256),
        nan=0.0).to(torch.int64)
    soft = gray[gi].reshape(m, -1)                   # (M, ms*3)
    return torch.where(ks[None, : soft.shape[1]], 1.0 - soft, soft)


def demod_candidates_flat(y: torch.Tensor, chan: torch.Tensor,
                          t0: torch.Tensor, of: torch.Tensor,
                          df: torch.Tensor, max_symbols: int,
                          f_all: torch.Tensor) -> torch.Tensor:
    """(C, T, 2) stream, M candidates and f_all = polyphase_filter(y)
    (C, 4, T, 2) -> (M, 3 * max_symbols) descrambled soft bits, as JAX's
    demod_candidates_flat (vdlm2dec_tpu/ops/demod.py:301-343).

    Symbol k is f_all at the candidate's polyphase clk0 % 4 and position
    t0 + s1 + 8k (zero past the stream); the phase before the first
    symbol filters y[t0-16 .. t0] with the clk0-extended taps.  The
    soft bits come from the exact float32 Gray table, not the split
    bfloat16 lookup of the inline demod.  Out-of-range channel and
    window starts clamp, as XLA's dynamic_slice and gather do."""
    ext_taps, _poly, _gray_soft, ks, gray = _demod_tables(y.device)
    c, t, _ = y.shape
    ms = max_symbols
    ci = torch.clamp(chan.to(torch.int64), 0, c - 1)
    clk0 = _clk0(of)
    # window of 17 starting at t0 in the 16-left-padded stream
    ypad = F.pad(y, (0, 0, 16, 0))
    start = torch.clamp(t0.to(torch.int64), 0, t - 1)
    idx = start[:, None] + torch.arange(17, device=y.device)
    win = ypad[ci[:, None], idx]                     # (M, 17, 2)
    s1v = (win * ext_taps[clk0][:, :, None]).sum(dim=1)
    p1 = torch.atan2(s1v[:, 1], s1v[:, 0])
    s1 = (32 - clk0 + 3) // 4
    overrun = 7 + 8 * ms
    pos = (t0.to(torch.int64) + s1)[:, None] \
        + 8 * torch.arange(ms, device=y.device)
    pos = torch.clamp(pos, 0, t + overrun - 1)
    inside = (pos < t)[..., None]
    f = f_all[ci[:, None], (clk0 % 4)[:, None], torch.clamp(pos, max=t - 1)]
    f = torch.where(inside, f, torch.zeros_like(f))  # (M, ms, 2)
    p = torch.atan2(f[..., 1], f[..., 0])
    return _soft_bits(p, p1, df, gray, ks)


def demod_candidates_inline(y: torch.Tensor, chan: torch.Tensor,
                            t0: torch.Tensor, of: torch.Tensor,
                            df: torch.Tensor, max_symbols: int
                            ) -> torch.Tensor:
    """(C, T, 2) stream + M candidates -> (M, 3 * max_symbols) descrambled
    soft bits P(bit = 1), symbol-major.

    Each candidate's window of y starting at its trigger is filtered at
    the candidate's polyphase (clk0 % 4 of the rounded timing offset);
    symbol k sits at window sample s1 + 8k with s1 = (35 - clk0) // 4 in
    5..8, and the phase before the first symbol comes from the trigger-
    time filteredphase with the clk0-extended taps."""
    ext_taps, poly, gray, ks, _gray32 = _demod_tables(y.device)
    ms = max_symbols
    win_len = 8 * (ms + 4)          # covers s1 + 8*ms + 17
    ypad = F.pad(y, (0, 0, 16, win_len))
    m = chan.shape[0]
    clk0 = _clk0(of)
    phi = clk0 % 4
    s1 = (32 - clk0 + 3) // 4

    idx = t0.to(torch.int64)[:, None] + torch.arange(win_len, device=y.device)
    w = ypad[chan.to(torch.int64)[:, None], idx]     # (M, win_len, 2)

    taps1 = ext_taps[clk0]                           # (M, 17)
    s1v = (w[:, : taps1.shape[1]] * taps1[:, :, None]).sum(dim=1)
    p1 = torch.atan2(s1v[:, 1], s1v[:, 0])

    tp = poly[phi]                                   # (M, 17)
    l = win_len - 16
    f = tp[:, 0, None, None] * w[:, 0:l]
    for j in range(1, 17):
        f = f + tp[:, j, None, None] * w[:, j:j + l]
    # symbol k at filter index s1 + 8k: row k + s1 // 8, column s1 % 8
    fv = f.reshape(m, l // 8, 8, 2)
    rows = (torch.arange(ms, device=y.device)[None, :]
            + (s1 // 8)[:, None])                    # (M, ms)
    sym = fv[torch.arange(m, device=y.device)[:, None], rows,
             (s1 % 8)[:, None]]                      # (M, ms, 2)

    p = torch.atan2(sym[..., 1], sym[..., 0])
    return _soft_bits(p, p1, df, gray, ks)

