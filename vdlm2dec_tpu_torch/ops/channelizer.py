"""Channelizers: wideband planes -> per-channel 84 kHz streams.

The reference mixes every channel with its LO and integrates-and-dumps
(d8psk.c:353-381).  The decimation pattern repeats every P_in = 4 sdrclk
input samples, so per period b the whole channelizer is

    y[c, b, :] = ph[c, b] * (x[b, :] * lo[c, :]) @ A        (A: P_in x 84)

with lo the channel's LO over one period and ph its phase at the period
start (exactly 1 with the reference's wrapped LO table).  Four forms of
it, each matching one JAX function (vdlm2dec_tpu/ops/channelizer.py):

  "matmul"  the dense form above (_channelize_jit); any plan, both LO
            modes.  ops/chan_u8.py fuses it for cu8 bytes on a card (the
            port of the Pallas ingest kernel)
  "fir"     filter_mode="fir" on the matmul form (_channelize_fir_jit):
            A becomes a (P_in + 2 pad, 84) windowed-sinc matrix whose
            taps reach pad samples into the neighbouring periods
  "dft"     residue space (_channelize_dft_qr_jit): the wrapped LO is
            periodic in tbl = fs/25 kHz samples, so with x reshaped to
            (B, Q, tbl) (see _tables.dft_qr_tables)
                z[b, r, m] = sum_q x[b, q, r] * a2[q, r, m]
                y[c, b, m] = sum_r w[c, r] * z[b, r, m]
  "pfb"     the same z, then all tbl raster bins by a factorized DFT
            (DFT_a -> twiddle -> DFT_b) and a gather of the channels'
            bins (_channelize_pfb_jit)

All of them are plain matmuls and elementwise passes; no hand kernel is
needed for them.  compute="bf16" rounds each matmul operand to bfloat16
exactly where the JAX code casts it (mm_operand); the contraction stays
float32, as JAX's preferred_element_type=float32.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .._tables import (
    aggregation_matrix,
    dft_qr_tables,
    fir_aggregation_matrix,
    lo_tables,
    period_for,
    period_phases,
    pfb_tables,
)
from . import chan_u8
from .ingest import DC_OFFSET

IMPLS = ("matmul", "dft", "pfb")
FILTER_MODES = ("boxcar", "fir")
COMPUTES = ("f32", "bf16")


def set_f32_matmul() -> None:
    """compute="f32" means full float32 products, as the JAX package's
    Precision.HIGHEST: TF32 stays off for matmuls and convolutions.
    compute="bf16" relies on it too: its rounded operands are then
    multiplied exactly and summed in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mm_operand(x: torch.Tensor, compute: str) -> torch.Tensor:
    """A matmul operand under a compute mode (JAX's mm_mode,
    vdlm2dec_tpu/ops/channelizer.py:304-314): "bf16" rounds it to
    bfloat16 and back to float32, as `.astype(bfloat16)` before a dot
    with float32 accumulation; "f32" leaves it.  A bfloat16 matmul in
    PyTorch would also round the sums, which JAX does not."""
    if compute == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _residues(x: torch.Tensor, a2: torch.Tensor, split: bool,
              interleave: bool = False, compute: str = "f32"
              ) -> torch.Tensor:
    """(B, P_in) plane -> (B, tbl, 84) residue space z.

    In the split layout each period row holds its even samples in the
    first half and its odd samples in the second; each half reshapes to
    (B, Q, tbl/2) and contracts against its half of a2.  The halves come
    back concatenated (split residue order, matching the split w) or,
    with interleave=True, interleaved into true residue order."""
    b = x.shape[0]
    q_n, tbl, p_out = a2.shape
    a2 = mm_operand(a2, compute)
    if not split:
        return torch.einsum("bqr,qrm->brm",
                            mm_operand(x.reshape(b, q_n, tbl), compute), a2)
    h = x.shape[1] // 2
    ze = torch.einsum("bqr,qrm->brm",
                      mm_operand(x[:, :h].reshape(b, q_n, tbl // 2), compute),
                      a2[:, : tbl // 2])
    zo = torch.einsum("bqr,qrm->brm",
                      mm_operand(x[:, h:].reshape(b, q_n, tbl // 2), compute),
                      a2[:, tbl // 2:])
    if interleave:
        return torch.stack([ze, zo], dim=2).reshape(b, tbl, p_out)
    return torch.cat([ze, zo], dim=1)


def channelize_dft_qr(x_r: torch.Tensor, x_i: torch.Tensor,
                      w_r: torch.Tensor, w_i: torch.Tensor,
                      a2: torch.Tensor, split: bool, compute: str = "f32"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, P_in) planes (sample order, or split-phase order with
    split=True and the matching split tables) -> (C, B*84) planes."""
    zr = mm_operand(_residues(x_r, a2, split, compute=compute), compute)
    zi = mm_operand(_residues(x_i, a2, split, compute=compute), compute)
    w_r, w_i = mm_operand(w_r, compute), mm_operand(w_i, compute)
    yr = (torch.einsum("cr,brm->cbm", w_r, zr)
          - torch.einsum("cr,brm->cbm", w_i, zi))
    yi = (torch.einsum("cr,brm->cbm", w_r, zi)
          + torch.einsum("cr,brm->cbm", w_i, zr))
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


def _mix(x_r, x_i, lo_r, lo_i, ph_r, ph_i):
    """(B, P_in) planes x (C, P_in) LO x (C, B) period phase -> the mixed
    (C, B, P_in) planes."""
    mr = x_r[None] * lo_r[:, None, :] - x_i[None] * lo_i[:, None, :]
    mi = x_r[None] * lo_i[:, None, :] + x_i[None] * lo_r[:, None, :]
    return (mr * ph_r[:, :, None] - mi * ph_i[:, :, None],
            mr * ph_i[:, :, None] + mi * ph_r[:, :, None])


def channelize_matmul(x_r: torch.Tensor, x_i: torch.Tensor,
                      lo_r: torch.Tensor, lo_i: torch.Tensor,
                      ph_r: torch.Tensor, ph_i: torch.Tensor,
                      a: torch.Tensor, compute: str = "f32"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense mix + period phase + integrate-and-dump: x (B, P_in) planes,
    lo (C, P_in), ph (C, B), a (P_in, 84) -> (C, B*84) planes."""
    zr, zi = _mix(x_r, x_i, lo_r, lo_i, ph_r, ph_i)
    a = mm_operand(a, compute)
    yr = torch.einsum("cbn,nm->cbm", mm_operand(zr, compute), a)
    yi = torch.einsum("cbn,nm->cbm", mm_operand(zi, compute), a)
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


def channelize_fir(x_r: torch.Tensor, x_i: torch.Tensor,
                   lo_r: torch.Tensor, lo_i: torch.Tensor,
                   ph_r: torch.Tensor, ph_i: torch.Tensor,
                   a_fir: torch.Tensor, pad: int, compute: str = "f32"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """FIR decimation: x (B, P_in) planes, a_fir (P_in + 2 pad, 84) ->
    (C, B*84) planes.  Each channel's mixed stream is zero-padded by pad
    on both sides (block edges see zeros; there is no history across
    calls), and output period b is window padded[b P_in : b P_in + n]
    @ a_fir, n = P_in + 2 pad.

    The windows overlap, and JAX gathers them into a (C, B, n) tensor.
    Here each channel's padded stream is laid out as rows of P_in in one
    buffer, so window b is row b followed by the leading samples of the
    next rows: one 2-D matmul per row offset reads the rows in place
    (strided views, no copy) and the partial products add up to the
    n-term dot."""
    b, p_in = x_r.shape
    c = lo_r.shape[0]
    n = a_fir.shape[0]
    k = -(-n // p_in)                  # rows a window spans
    r = b + k - 1                      # rows per channel
    a_fir = mm_operand(a_fir, compute)
    out = []
    for z in _mix(x_r, x_i, lo_r, lo_i, ph_r, ph_i):
        buf = z.new_zeros(c * r + k - 1, p_in)
        buf[: c * r].view(c, r * p_in)[:, pad: pad + b * p_in] = \
            z.reshape(c, b * p_in)
        buf = mm_operand(buf, compute)
        y = None
        for j in range(k):
            w = min(p_in, n - j * p_in)
            part = buf[j: j + c * r, :w] @ a_fir[j * p_in: j * p_in + w]
            y = part if y is None else y + part
        out.append(y.view(c, r, -1)[:, :b].reshape(c, -1))
    return out[0], out[1]


def _cmatmul(spec: str, mr, mi, vr, vi):
    """Complex einsum on re/im planes."""
    return (torch.einsum(spec, mr, vr) - torch.einsum(spec, mi, vi),
            torch.einsum(spec, mr, vi) + torch.einsum(spec, mi, vr))


def channelize_pfb(x_r: torch.Tensor, x_i: torch.Tensor, a2: torch.Tensor,
                   dfa: torch.Tensor, tw: torch.Tensor, dfb: torch.Tensor,
                   bins: torch.Tensor, split: bool, compute: str = "f32"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Residue contraction + factorized-DFT filterbank: x (B, P_in)
    planes -> (C, B*84) planes.  The DFT needs z in true residue order
    r = r1*b + r2, so split-layout halves interleave back.  The twiddle
    multiplies in float32 under either compute mode, as in JAX."""
    bsz = x_r.shape[0]
    p_out = a2.shape[2]
    a, b = dfa.shape[0], dfb.shape[0]
    zr, zi = (mm_operand(_residues(x, a2, split, interleave=True,
                                   compute=compute), compute)
              .reshape(bsz, a, b, p_out) for x in (x_r, x_i))
    dfa_r, dfa_i = mm_operand(dfa[..., 0], compute), \
        mm_operand(dfa[..., 1], compute)
    dfb_r, dfb_i = mm_operand(dfb[..., 0], compute), \
        mm_operand(dfb[..., 1], compute)
    # stage 1: DFT over r1 -> (B, k1, r2, 84)
    ar, ai = _cmatmul("kr,brcm->bkcm", dfa_r, dfa_i, zr, zi)
    # twiddle W_tbl^{k1 r2}
    twr, twi = tw[None, :, :, None, 0], tw[None, :, :, None, 1]
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    # stage 2: DFT over r2 -> (B, k1, k2, 84)
    yr, yi = _cmatmul("kc,bqcm->bqkm", dfb_r, dfb_i,
                      mm_operand(br, compute), mm_operand(bi, compute))
    k1, k2 = bins[:, 0].long(), bins[:, 1].long()
    yr = yr[:, k1, k2, :].transpose(0, 1)
    yi = yi[:, k1, k2, :].transpose(0, 1)
    c = k1.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)


class Channelizer(nn.Module):
    """The JAX package's Channelizer: one channel plan, one
    implementation, one filter and compute mode, its tables as device
    buffers and the period cursor of the stream position.

    impl "matmul" holds lo_r, lo_i (C, P_in), a (P_in, 84) and, with
    filter_mode="fir", a_fir (P_in + 2 fir_pad, 84); "dft" the residue
    tables (w_r, w_i, a2) per plane layout, built lazily (a band-scale a2
    is tens of MB); "pfb" the filterbank tables and the a2 of a layout.
    real_input (an airspy real capture) zeroes the imaginary plane of
    what channelize() is given."""

    def __init__(self, f_offsets, fs: int = 2_000_000,
                 sdrclk: int | None = None, lo_wrap: bool = True,
                 impl: str = "dft", device="cpu", real_input: bool = False,
                 filter_mode: str = "boxcar", compute: str = "f32"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if filter_mode not in FILTER_MODES:
            raise ValueError(f"filter_mode must be one of {FILTER_MODES}, "
                             f"got {filter_mode!r}")
        if compute not in COMPUTES:
            raise ValueError(f"compute must be one of {COMPUTES}, "
                             f"got {compute!r}")
        if impl != "matmul" and not lo_wrap:
            raise ValueError("the residue-space (dft/pfb) channelizers "
                             "require lo_wrap=True")
        if impl != "matmul" and filter_mode != "boxcar":
            raise ValueError("the residue-space (dft/pfb) channelizers "
                             "require the boxcar filter")
        self.fs = fs
        self.sdrclk = sdrclk if sdrclk is not None else fs // 4000
        self.f_offsets = tuple(float(f) for f in f_offsets)
        self.lo_wrap = lo_wrap
        self.impl = impl
        self.real_input = real_input
        self.filter_mode = filter_mode
        self.compute = compute
        self.p_in, self.p_out = period_for(self.sdrclk)
        self.device = torch.device(device)
        self._period_cursor = 0
        if impl == "matmul":
            lo, _ = lo_tables(self.f_offsets, fs, self.sdrclk, lo_wrap)
            self._set_tables(lo_r=lo.real, lo_i=lo.imag,
                             a=aggregation_matrix(self.sdrclk))
            if filter_mode == "fir":
                a_fir, self.fir_pad = fir_aggregation_matrix(self.sdrclk, fs)
                self._set_tables(a_fir=a_fir)
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
            if self.filter_mode == "fir":
                yr, yi = channelize_fir(x_r, x_i, self.lo_r, self.lo_i,
                                        ph_r, ph_i, self.a_fir, self.fir_pad,
                                        self.compute)
            else:
                yr, yi = channelize_matmul(x_r, x_i, self.lo_r, self.lo_i,
                                           ph_r, ph_i, self.a, self.compute)
        else:
            # the wrapped LO makes every period's phase exactly 1: the
            # block position only moves the cursor
            if period0 is None:
                self._period_cursor += b
            w_r, w_i, a2 = self.qr_tables(split)
            if self.impl == "dft":
                yr, yi = channelize_dft_qr(x_r, x_i, w_r, w_i, a2, split,
                                           self.compute)
            else:
                yr, yi = channelize_pfb(x_r, x_i, a2, self.pfb_dfa,
                                        self.pfb_tw, self.pfb_dfb,
                                        self.pfb_bins, split, self.compute)
        return torch.stack([yr, yi], dim=-1)

    def channelize(self, x, period0: int | None = None) -> torch.Tensor:
        """The JAX Channelizer's sample entry (its __call__,
        vdlm2dec_tpu/ops/channelizer.py:617-675): x is (T,) complex or
        real samples or (T, 2) re/im planes, numpy or torch, T a whole
        number of periods -> (C, T*84/P_in, 2) float32 on the
        channelizer's device.  Real samples, and any samples under
        real_input, have a zero imaginary plane.  period0 as in
        forward()."""
        planes = x.ndim == 2 and x.shape[-1] == 2
        t = x.shape[0] if planes else x.shape[-1]
        if t % self.p_in:
            raise ValueError(f"block of {t} samples is not a whole number "
                             f"of {self.p_in}-sample periods")
        if planes:
            re, im = x[:, 0], x[:, 1]
        elif (x.is_complex() if torch.is_tensor(x)
              else np.iscomplexobj(x)):
            re, im = x.real, x.imag
        else:
            re, im = x, None
        x_r = self._plane(re)
        x_i = torch.zeros_like(x_r) if im is None or self.real_input \
            else self._plane(im)
        return self(x_r, x_i, split=False, period0=period0)

    def _plane(self, v) -> torch.Tensor:
        """One real plane, numpy or torch -> (B, P_in) float32 on the
        channelizer's device (numpy converts on the host first)."""
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        return v.to(device=self.device,
                    dtype=torch.float32).reshape(-1, self.p_in)

    def forward_u8(self, raw: torch.Tensor) -> torch.Tensor:
        """Interleaved cu8 bytes (B * P_in * 2,) -> (C, B*84, 2) through
        the fused u8 channelizer (ops/chan_u8.py: the kernel on a card,
        its plain version on the CPU).  matmul and boxcar only; compute
        does not apply, as in the JAX package's Pallas path."""
        if self.impl != "matmul" or self.filter_mode != "boxcar":
            raise ValueError("the fused u8 channelizer is the dense "
                             "boxcar matmul form; this channelizer is "
                             f"{self.impl!r} / {self.filter_mode!r}")
        b = raw.numel() // (2 * self.p_in)
        ph_r, ph_i = self.phases(b)
        y4 = chan_u8.channelize_u8(raw, self.lo_r, self.lo_i, ph_r, ph_i,
                                   self.a, DC_OFFSET)
        return y4.reshape(y4.shape[0], -1, 2)
