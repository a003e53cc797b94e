"""Ingest: raw capture samples -> float32 (B, P_in) planes.

Every capture format converts exactly (integer -> float32 conversions
and copies), as the JAX package's _raw_to_planes / _raw_to_planes_split
(vdlm2dec_tpu/pipeline.py:292-341) do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io.sdr import RTL_DC_OFFSET

# the DC offset as the float32 the planes subtract (rtl.c:274-295)
DC_OFFSET = float(np.float32(RTL_DC_OFFSET))

# the raw array's dtype per capture format
RAW_DTYPES = {
    "cu8": torch.uint8,
    "cs16": torch.int16,
    "cf32": torch.float32,
    "f32real": torch.float32,
}


def _check_raw(raw: torch.Tensor, fmt: str, p_in: int) -> None:
    if fmt not in RAW_DTYPES:
        raise ValueError(f"unknown capture format {fmt!r}")
    if raw.dtype != RAW_DTYPES[fmt] or raw.dim() != 1:
        raise ValueError(f"{fmt} raw must be a 1-D {RAW_DTYPES[fmt]} tensor, "
                         f"got {raw.dim()}-D {raw.dtype}")
    per = 1 if fmt == "f32real" else 2
    if raw.numel() % (per * p_in):
        raise ValueError(f"raw length {raw.numel()} is not a whole number "
                         f"of {p_in}-sample periods")


def raw_to_planes(raw: torch.Tensor, fmt: str, p_in: int,
                  dc_offset: float = DC_OFFSET
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) raw samples of a capture format -> (x_r, x_i) float32 planes
    of shape (B, p_in) in sample order.

      cu8      byte pairs (re, im) as one little-endian 16-bit word, the
               rtl_sdr DC offset subtracted
      cs16     int16 pairs as one int32 word, sign-extended by
               arithmetic shifts
      cf32     float32 pairs, deinterleaved
      f32real  airspy real samples, x_i = 0 (the fs/4 arrangement is in
               the channel offsets)"""
    _check_raw(raw, fmt, p_in)
    if fmt == "f32real":
        x_r = raw.reshape(-1, p_in)
        return x_r, torch.zeros_like(x_r)
    if fmt == "cu8":
        u = raw.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        x_r = (u & 0xFF).to(torch.float32) - dc_offset
        x_i = (u >> 8).to(torch.float32) - dc_offset
    elif fmt == "cs16":
        w = raw.contiguous().view(torch.int32)
        x_r = ((w << 16) >> 16).to(torch.float32)
        x_i = (w >> 16).to(torch.float32)
    else:
        x_r, x_i = raw[0::2], raw[1::2]
    return x_r.reshape(-1, p_in), x_i.reshape(-1, p_in)


def raw_to_planes_split(raw: torch.Tensor, p_in: int,
                        dc_offset: float = DC_OFFSET
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) uint8 interleaved cu8 -> (x_r, x_i) float32 planes of shape
    (N / (2 p_in), p_in) in split-phase layout [even samples | odd
    samples] per period row.

    Four bytes (re0, im0, re1, im1) are one little-endian int32, so the
    deinterleave is shifts and masks on a dense int32 view; the layout
    permutation is absorbed by the channelizer's split tables
    (_tables.dft_qr_tables(split=True))."""
    _check_raw(raw, "cu8", p_in)
    w = raw.contiguous().view(torch.int32)
    re0 = (w & 0xFF).to(torch.float32) - dc_offset
    im0 = ((w >> 8) & 0xFF).to(torch.float32) - dc_offset
    re1 = ((w >> 16) & 0xFF).to(torch.float32) - dc_offset
    im1 = ((w >> 24) & 0xFF).to(torch.float32) - dc_offset
    h = p_in // 2
    x_r = torch.cat([re0.reshape(-1, h), re1.reshape(-1, h)], dim=1)
    x_i = torch.cat([im0.reshape(-1, h), im1.reshape(-1, h)], dim=1)
    return x_r, x_i
