"""Channelizers: wideband planes -> per-channel 84 kHz streams.

The reference mixes every channel with its LO and integrates-and-dumps
(d8psk.c:353-381).  The decimation pattern repeats every P_in = 4 sdrclk
input samples, so per period b the whole channelizer is

    y[c, b, :] = ph[c, b] * (x[b, :] * lo[c, :]) @ A        (A: P_in x 84)

with lo the channel's LO over one period and ph its phase at the period
start (exactly 1 with the reference's wrapped LO table).  Three forms of
it, each matching one JAX function (vdlm2dec_tpu/ops/channelizer.py):

  "matmul"  the dense form above (_channelize_jit); any plan, both LO
            modes.  ops/chan_u8.py fuses it for cu8 bytes on a card (the
            port of the Pallas ingest kernel)
  "dft"     residue space (_channelize_dft_qr_jit): the wrapped LO is
            periodic in tbl = fs/25 kHz samples, so with x reshaped to
            (B, Q, tbl) (see _tables.dft_qr_tables)
                z[b, r, m] = sum_q x[b, q, r] * a2[q, r, m]
                y[c, b, m] = sum_r w[c, r] * z[b, r, m]
  "pfb"     the same z, then all tbl raster bins by a factorized DFT
            (DFT_a -> twiddle -> DFT_b) and a gather of the channels'
            bins (_channelize_pfb_jit)

All of them are plain matmuls and elementwise passes; no hand kernel is
needed for them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .._tables import (
    aggregation_matrix,
    dft_qr_tables,
    lo_tables,
    period_for,
    period_phases,
    pfb_tables,
)
from . import chan_u8
from .ingest import DC_OFFSET

IMPLS = ("matmul", "dft", "pfb")


def set_f32_matmul() -> None:
    """compute="f32" means full float32 products, as the JAX package's
    Precision.HIGHEST: TF32 stays off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _residues(x: torch.Tensor, a2: torch.Tensor, split: bool,
              interleave: bool = False) -> torch.Tensor:
    """(B, P_in) plane -> (B, tbl, 84) residue space z.

    In the split layout each period row holds its even samples in the
    first half and its odd samples in the second; each half reshapes to
    (B, Q, tbl/2) and contracts against its half of a2.  The halves come
    back concatenated (split residue order, matching the split w) or,
    with interleave=True, interleaved into true residue order."""
    b = x.shape[0]
    q_n, tbl, p_out = a2.shape
    if not split:
        return torch.einsum("bqr,qrm->brm", x.reshape(b, q_n, tbl), a2)
    h = x.shape[1] // 2
    ze = torch.einsum("bqr,qrm->brm", x[:, :h].reshape(b, q_n, tbl // 2),
                      a2[:, : tbl // 2])
    zo = torch.einsum("bqr,qrm->brm", x[:, h:].reshape(b, q_n, tbl // 2),
                      a2[:, tbl // 2:])
    if interleave:
        return torch.stack([ze, zo], dim=2).reshape(b, tbl, p_out)
    return torch.cat([ze, zo], dim=1)


def channelize_dft_qr(x_r: torch.Tensor, x_i: torch.Tensor,
                      w_r: torch.Tensor, w_i: torch.Tensor,
                      a2: torch.Tensor, split: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, P_in) planes (sample order, or split-phase order with
    split=True and the matching split tables) -> (C, B*84) planes."""
    zr = _residues(x_r, a2, split)
    zi = _residues(x_i, a2, split)
    yr = (torch.einsum("cr,brm->cbm", w_r, zr)
          - torch.einsum("cr,brm->cbm", w_i, zi))
    yi = (torch.einsum("cr,brm->cbm", w_r, zi)
          + torch.einsum("cr,brm->cbm", w_i, zr))
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


def channelize_matmul(x_r: torch.Tensor, x_i: torch.Tensor,
                      lo_r: torch.Tensor, lo_i: torch.Tensor,
                      ph_r: torch.Tensor, ph_i: torch.Tensor,
                      a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense mix + period phase + integrate-and-dump: x (B, P_in) planes,
    lo (C, P_in), ph (C, B), a (P_in, 84) -> (C, B*84) planes."""
    mr = x_r[None] * lo_r[:, None, :] - x_i[None] * lo_i[:, None, :]
    mi = x_r[None] * lo_i[:, None, :] + x_i[None] * lo_r[:, None, :]
    zr = mr * ph_r[:, :, None] - mi * ph_i[:, :, None]
    zi = mr * ph_i[:, :, None] + mi * ph_r[:, :, None]
    yr = torch.einsum("cbn,nm->cbm", zr, a)
    yi = torch.einsum("cbn,nm->cbm", zi, a)
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


def _cmatmul(spec: str, mr, mi, vr, vi):
    """Complex einsum on re/im planes."""
    return (torch.einsum(spec, mr, vr) - torch.einsum(spec, mi, vi),
            torch.einsum(spec, mr, vi) + torch.einsum(spec, mi, vr))


def channelize_pfb(x_r: torch.Tensor, x_i: torch.Tensor, a2: torch.Tensor,
                   dfa: torch.Tensor, tw: torch.Tensor, dfb: torch.Tensor,
                   bins: torch.Tensor, split: bool
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Residue contraction + factorized-DFT filterbank: x (B, P_in)
    planes -> (C, B*84) planes.  The DFT needs z in true residue order
    r = r1*b + r2, so split-layout halves interleave back."""
    bsz = x_r.shape[0]
    p_out = a2.shape[2]
    a, b = dfa.shape[0], dfb.shape[0]
    zr = _residues(x_r, a2, split, interleave=True).reshape(bsz, a, b, p_out)
    zi = _residues(x_i, a2, split, interleave=True).reshape(bsz, a, b, p_out)
    # stage 1: DFT over r1 -> (B, k1, r2, 84)
    ar, ai = _cmatmul("kr,brcm->bkcm", dfa[..., 0], dfa[..., 1], zr, zi)
    # twiddle W_tbl^{k1 r2}
    twr, twi = tw[None, :, :, None, 0], tw[None, :, :, None, 1]
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    # stage 2: DFT over r2 -> (B, k1, k2, 84)
    yr, yi = _cmatmul("kc,bqcm->bqkm", dfb[..., 0], dfb[..., 1], br, bi)
    k1, k2 = bins[:, 0].long(), bins[:, 1].long()
    yr = yr[:, k1, k2, :].transpose(0, 1)
    yi = yi[:, k1, k2, :].transpose(0, 1)
    c = k1.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


class Channelizer(nn.Module):
    """The JAX package's Channelizer for the boxcar filter: one channel
    plan, one implementation, its tables as device buffers and the period
    cursor of the stream position.

    impl "matmul" holds lo_r, lo_i (C, P_in) and a (P_in, 84); "dft" the
    residue tables (w_r, w_i, a2) per plane layout, built lazily (a
    band-scale a2 is tens of MB); "pfb" the filterbank tables and the
    a2 of a layout."""

    def __init__(self, f_offsets, fs: int = 2_000_000,
                 sdrclk: int | None = None, lo_wrap: bool = True,
                 impl: str = "dft", device="cpu"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if impl != "matmul" and not lo_wrap:
            raise ValueError("the residue-space (dft/pfb) channelizers "
                             "require lo_wrap=True")
        self.fs = fs
        self.sdrclk = sdrclk if sdrclk is not None else fs // 4000
        self.f_offsets = tuple(float(f) for f in f_offsets)
        self.lo_wrap = lo_wrap
        self.impl = impl
        self.p_in, self.p_out = period_for(self.sdrclk)
        self.device = torch.device(device)
        self._period_cursor = 0
        if impl == "matmul":
            lo, _ = lo_tables(self.f_offsets, fs, self.sdrclk, lo_wrap)
            self._set_tables(lo_r=lo.real, lo_i=lo.imag,
                             a=aggregation_matrix(self.sdrclk))
        elif impl == "pfb":
            _a, _b, dfa, tw, dfb, bins = pfb_tables(self.f_offsets, fs,
                                                    self.sdrclk)
            self._set_tables(pfb_dfa=dfa, pfb_tw=tw, pfb_dfb=dfb,
                             pfb_bins=bins)

    @classmethod
    def from_numpy_tables(cls, f_offsets, tables: dict, fs: int = 2_000_000,
                          sdrclk: int | None = None, lo_wrap: bool = True,
                          impl: str = "dft", period_cursor: int = 0,
                          device="cpu") -> "Channelizer":
        """A channelizer whose tables are the given arrays (another
        implementation's constants, carried across), by buffer name:
        lo_r, lo_i, a (matmul); w_r_s, w_i_s, a2_s / w_r_n, w_i_n, a2_n
        (dft, split / sample order); pfb_dfa, pfb_tw, pfb_dfb, pfb_bins
        and an a2 (pfb).  Tables not given are the channelizer's own."""
        ch = cls(f_offsets, fs=fs, sdrclk=sdrclk, lo_wrap=lo_wrap,
                 impl=impl, device=device)
        ch._period_cursor = int(period_cursor)
        ch._set_tables(**tables)
        return ch

    def _set_tables(self, **arrays) -> None:
        for name, v in arrays.items():
            v = np.asarray(v)
            dt = np.int32 if v.dtype.kind in "iu" else np.float32
            self.register_buffer(name, torch.tensor(v.astype(dt),
                                                    device=self.device))

    def qr_tables(self, split: bool) -> tuple[torch.Tensor, ...]:
        """(w_r, w_i, a2) for split-phase (True) or sample-order planes."""
        suffix = "s" if split else "n"
        if not hasattr(self, f"a2_{suffix}"):
            w, a2 = dft_qr_tables(self.f_offsets, self.fs, self.sdrclk,
                                  split)
            self._set_tables(**{f"w_r_{suffix}": w.real,
                                f"w_i_{suffix}": w.imag,
                                f"a2_{suffix}": a2})
        return (getattr(self, f"w_r_{suffix}"), getattr(self, f"w_i_{suffix}"),
                getattr(self, f"a2_{suffix}"))

    def phases(self, n_periods: int, period0: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(ph_r, ph_i), each (C, n_periods): the LO phase at the start of
        each period from period0, or from the cursor (advanced by
        n_periods) when period0 is None."""
        start = self._period_cursor if period0 is None else period0
        if period0 is None:
            self._period_cursor += n_periods
        ph = period_phases(self.f_offsets, self.fs, self.sdrclk,
                           self.lo_wrap, n_periods, start)
        return (torch.tensor(ph.real, device=self.device),
                torch.tensor(ph.imag, device=self.device))

    def forward(self, x_r: torch.Tensor, x_i: torch.Tensor,
                split: bool = False, period0: int | None = None
                ) -> torch.Tensor:
        """(B, P_in) planes (split-phase layout with split=True, dft and
        pfb only) -> (C, B*84, 2) re/im.  period0 is the absolute period
        of x[0] (overlapping reads addressed by position); when None the
        cursor supplies it and advances by B."""
        b = x_r.shape[0]
        if self.impl == "matmul":
            if split:
                raise ValueError("the matmul channelizer takes "
                                 "sample-order planes")
            ph_r, ph_i = self.phases(b, period0)
            yr, yi = channelize_matmul(x_r, x_i, self.lo_r, self.lo_i,
                                       ph_r, ph_i, self.a)
        else:
            # the wrapped LO makes every period's phase exactly 1: the
            # block position only moves the cursor
            if period0 is None:
                self._period_cursor += b
            w_r, w_i, a2 = self.qr_tables(split)
            if self.impl == "dft":
                yr, yi = channelize_dft_qr(x_r, x_i, w_r, w_i, a2, split)
            else:
                yr, yi = channelize_pfb(x_r, x_i, a2, self.pfb_dfa,
                                        self.pfb_tw, self.pfb_dfb,
                                        self.pfb_bins, split)
        return torch.stack([yr, yi], dim=-1)

    def forward_u8(self, raw: torch.Tensor) -> torch.Tensor:
        """Interleaved cu8 bytes (B * P_in * 2,) -> (C, B*84, 2) through
        the fused u8 channelizer (ops/chan_u8.py: the kernel on a card,
        its plain version on the CPU).  matmul only."""
        if self.impl != "matmul":
            raise ValueError("the fused u8 channelizer is the dense "
                             "matmul form; this channelizer is "
                             f"{self.impl!r}")
        b = raw.numel() // (2 * self.p_in)
        ph_r, ph_i = self.phases(b)
        y4 = chan_u8.channelize_u8(raw, self.lo_r, self.lo_i, ph_r, ph_i,
                                   self.a, DC_OFFSET)
        return y4.reshape(y4.shape[0], -1, 2)
