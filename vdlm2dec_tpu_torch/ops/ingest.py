"""cu8 ingest: raw rtl_sdr bytes -> split-phase float32 planes."""
from __future__ import annotations

import numpy as np
import torch

from vdlm2dec_tpu.io.sdr import RTL_DC_OFFSET

# the DC offset as the float32 the planes subtract (rtl.c:274-295)
DC_OFFSET = float(np.float32(RTL_DC_OFFSET))


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
    if raw.dtype != torch.uint8 or raw.dim() != 1:
        raise ValueError("raw must be a 1-D uint8 tensor")
    if raw.numel() % (2 * p_in):
        raise ValueError(f"raw length {raw.numel()} is not a whole number "
                         f"of {p_in}-sample periods")
    w = raw.contiguous().view(torch.int32)
    re0 = (w & 0xFF).to(torch.float32) - dc_offset
    im0 = ((w >> 8) & 0xFF).to(torch.float32) - dc_offset
    re1 = ((w >> 16) & 0xFF).to(torch.float32) - dc_offset
    im1 = ((w >> 24) & 0xFF).to(torch.float32) - dc_offset
    h = p_in // 2
    x_r = torch.cat([re0.reshape(-1, h), re1.reshape(-1, h)], dim=1)
    x_i = torch.cat([im0.reshape(-1, h), im1.reshape(-1, h)], dim=1)
    return x_r, x_i
