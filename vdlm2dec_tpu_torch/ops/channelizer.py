"""Residue-space channelizer: wideband planes -> per-channel 84 kHz streams.

The reference mixes every channel with a wrapped LO table of fs/25 kHz
samples and integrates-and-dumps (d8psk.c:353-381).  Because that table
length divides the decimation period, every input sample contributes to
exactly one (residue r, output m) cell, so the channelizer is two f32
contractions (see _tables.dft_qr_tables):

    z[b, r, m] = sum_q x[b, q, r] * a2[q, r, m]
    y[c, b, m] = sum_r w[c, r] * z[b, r, m]

Both are plain matmuls; no hand kernel is needed for them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vdlm2dec_tpu.constants import STEPRATE

from .._tables import dft_qr_tables, period_for


def set_f32_matmul() -> None:
    """compute="f32" means full float32 products, as the JAX package's
    Precision.HIGHEST: TF32 stays off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def channelize_dft_qr(x_r: torch.Tensor, x_i: torch.Tensor,
                      w_r: torch.Tensor, w_i: torch.Tensor,
                      a2: torch.Tensor, split: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, P_in) planes (sample order, or split-phase order with
    split=True and the matching split tables) -> (C, B*84) planes.

    In the split layout each period row holds its even samples in the
    first half and its odd samples in the second; each half reshapes to
    (B, Q, tbl/2) and contracts against its half of a2."""
    b = x_r.shape[0]
    q_n, tbl, p_out = a2.shape

    def z_of(x):
        if split:
            h = x.shape[1] // 2
            ze = torch.einsum("bqr,qrm->brm",
                              x[:, :h].reshape(b, q_n, tbl // 2),
                              a2[:, : tbl // 2])
            zo = torch.einsum("bqr,qrm->brm",
                              x[:, h:].reshape(b, q_n, tbl // 2),
                              a2[:, tbl // 2:])
            return torch.cat([ze, zo], dim=1)
        return torch.einsum("bqr,qrm->brm", x.reshape(b, q_n, tbl), a2)

    zr = z_of(x_r)
    zi = z_of(x_i)
    yr = (torch.einsum("cr,brm->cbm", w_r, zr)
          - torch.einsum("cr,brm->cbm", w_i, zi))
    yi = (torch.einsum("cr,brm->cbm", w_r, zi)
          + torch.einsum("cr,brm->cbm", w_i, zr))
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


class Channelizer(nn.Module):
    """The residue-space ("dft") channelizer of the JAX package, for the
    reference's wrapped-LO boxcar mode on a 25 kHz-raster plan.  Holds
    the (w_r, w_i, a2) tables per plane layout as device buffers, built
    lazily (a band-scale a2 is tens of MB), and the period cursor of the
    stream position."""

    def __init__(self, f_offsets, fs: int = 2_000_000,
                 sdrclk: int | None = None, device="cpu"):
        super().__init__()
        self.fs = fs
        self.sdrclk = sdrclk if sdrclk is not None else fs // 4000
        self.f_offsets = tuple(float(f) for f in f_offsets)
        self.p_in, self.p_out = period_for(self.sdrclk)
        self.device = torch.device(device)
        self._period_cursor = 0

    @classmethod
    def from_numpy_tables(cls, w_r: np.ndarray, w_i: np.ndarray,
                          a2: np.ndarray, period_cursor: int = 0,
                          split: bool = True, device="cpu") -> "Channelizer":
        """A channelizer whose tables for one plane layout are the given
        arrays (another implementation's constants, carried across).
        fs and sdrclk follow from a2's shape: a2 is (Q, tbl, 84) with
        tbl = fs / 25 kHz and Q * tbl = 4 * sdrclk."""
        q_n, tbl, _ = a2.shape
        fs = tbl * STEPRATE
        ch = cls((), fs=fs, sdrclk=q_n * tbl // 4, device=device)
        ch._period_cursor = int(period_cursor)
        ch._set_tables(split, w_r, w_i, a2)
        return ch

    def _set_tables(self, split, w_r, w_i, a2) -> None:
        suffix = "s" if split else "n"
        for name, v in (("w_r", w_r), ("w_i", w_i), ("a2", a2)):
            self.register_buffer(
                f"{name}_{suffix}",
                torch.tensor(np.asarray(v, dtype=np.float32),
                             device=self.device))

    def qr_tables(self, split: bool) -> tuple[torch.Tensor, ...]:
        """(w_r, w_i, a2) for split-phase (True) or sample-order planes."""
        suffix = "s" if split else "n"
        if not hasattr(self, f"a2_{suffix}"):
            w, a2 = dft_qr_tables(self.f_offsets, self.fs, self.sdrclk,
                                  split)
            self._set_tables(split, w.real, w.imag, a2)
        return (getattr(self, f"w_r_{suffix}"), getattr(self, f"w_i_{suffix}"),
                getattr(self, f"a2_{suffix}"))

    def forward(self, x_r: torch.Tensor, x_i: torch.Tensor,
                split: bool = True, period0: int | None = None
                ) -> torch.Tensor:
        """(B, P_in) planes -> (C, B*84, 2) re/im.  The wrapped LO makes
        every period's phase exactly 1, so the block position only moves
        the period cursor (advanced by B unless period0 is given, as for
        overlapping reads addressed by absolute position)."""
        if period0 is None:
            self._period_cursor += x_r.shape[0]
        yr, yi = channelize_dft_qr(x_r, x_i, *self.qr_tables(split), split)
        return torch.stack([yr, yi], dim=-1)
