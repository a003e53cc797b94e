"""Fused u8 channelizer: interleaved cu8 bytes -> (C, B, 84, 2) streams.

`channelize_u8` launches the CUDA kernel of csrc/chan_u8.cu on CUDA
tensors and runs the plain PyTorch version `channelize_u8_ref` on CPU
tensors.  It computes what the JAX package's `use_pallas` ingest does
(vdlm2dec_tpu/ops/pallas_channelizer.py, the Pallas kernel at :33 and
the period phase after it at :88-91):

    x[b, n]      = u8 - dc                     (re and im bytes)
    m[c, b, n]   = x[b, n] * lo[c, n]          (complex)
    y[c, b, k]   = ph[c, b] * sum_n m[c, b, n] * a[n, k]

The kernel takes the raw bytes as they arrive (no deinterleaved copy)
and uses the structure of the integrate-and-dump matrix a: every input n
has exactly one nonzero, in column owner(n), and each column's inputs
are one contiguous window.  So it sums the same nonzero products as the
dense product, in ascending n, with 1/84 of its multiply-adds.  It keeps
the LO and the weights in shared memory as [i][k] (i the index inside
window k), so that the threads of a warp, one output k each, read
neighbouring words: `window_slots` gives every input its place.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

# kernel launches since the last reset_launches()
launches = 0

# aggregation windows of each matrix handed to the kernel, derived once
# per tensor (the channelizer's `a` is a fixed table)
_windows: WeakIdKeyDictionary = WeakIdKeyDictionary()


def reset_launches() -> None:
    global launches
    launches = 0


def channelize_u8_ref(raw: torch.Tensor, lo_r: torch.Tensor,
                      lo_i: torch.Tensor, ph_r: torch.Tensor,
                      ph_i: torch.Tensor, a: torch.Tensor,
                      dc: float) -> torch.Tensor:
    """Plain version: the Pallas kernel's operations with the dense
    matmul, then the period phase."""
    b = ph_r.shape[1]
    pairs = raw.reshape(b, lo_r.shape[1], 2)
    xr = pairs[..., 0].to(torch.int32).to(torch.float32) - dc
    xi = pairs[..., 1].to(torch.int32).to(torch.float32) - dc
    mr = xr[None] * lo_r[:, None, :] - xi[None] * lo_i[:, None, :]
    mi = xr[None] * lo_i[:, None, :] + xi[None] * lo_r[:, None, :]
    yr = torch.einsum("cbn,nm->cbm", mr, a)
    yi = torch.einsum("cbn,nm->cbm", mi, a)
    zr = yr * ph_r[:, :, None] - yi * ph_i[:, :, None]
    zi = yr * ph_i[:, :, None] + yi * ph_r[:, :, None]
    return torch.stack([zr, zi], dim=-1)


def aggregation_windows(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(P_in, K) integrate-and-dump matrix -> (starts (K+1,) int32,
    weights (P_in,) float32): output k sums inputs starts[k] ..
    starts[k+1]-1, input n weighted by weights[n] = a[n, owner(n)].
    Raises unless every row has exactly one nonzero and the owners run
    0, .., K-1 without gaps (contiguous, non-empty windows)."""
    p_in, k_out = a.shape
    nz = a != 0
    if not (nz.sum(axis=1) == 1).all():
        raise ValueError("aggregation matrix: every input must feed "
                         "exactly one output")
    owner = nz.argmax(axis=1)
    steps = np.diff(owner)
    if owner[0] != 0 or owner[-1] != k_out - 1 or \
            not np.isin(steps, (0, 1)).all():
        raise ValueError("aggregation matrix: outputs must own contiguous, "
                         "non-empty windows in order")
    starts = np.searchsorted(owner, np.arange(k_out + 1)).astype(np.int32)
    return starts, a[np.arange(p_in), owner].astype(np.float32)


def window_slots(starts: np.ndarray) -> tuple[np.ndarray, int, int]:
    """Window starts (K+1,) -> (slots (P_in,) int32, pitch, maxlen): input
    n, the i-th of window k, sits at slots[n] = i * pitch + k of a
    (maxlen, pitch) plane; maxlen is the longest window.  pitch is K made
    odd: the kernel fills a plane one input a thread, so neighbouring
    threads store pitch elements apart, and an odd pitch spreads a warp's
    stores over all 32 shared-memory banks (K = 84 itself over 8)."""
    starts = np.asarray(starts, dtype=np.int64)
    k_out = len(starts) - 1
    pitch = k_out | 1
    lens = np.diff(starts)
    owner = np.repeat(np.arange(k_out), lens)
    within = np.arange(starts[-1]) - starts[owner]
    return (within * pitch + owner).astype(np.int32), pitch, int(lens.max())


def _device_windows(a: torch.Tensor):
    """(starts, weights, slots) on a's device, then pitch and maxlen."""
    if a not in _windows:
        starts, weights = aggregation_windows(a.detach().cpu().numpy())
        slots, pitch, maxlen = window_slots(starts)
        _windows[a] = (*(torch.from_numpy(v).to(a.device)
                         for v in (starts, weights, slots)), pitch, maxlen)
    return _windows[a]


def channelize_u8(raw: torch.Tensor, lo_r: torch.Tensor, lo_i: torch.Tensor,
                  ph_r: torch.Tensor, ph_i: torch.Tensor, a: torch.Tensor,
                  dc: float) -> torch.Tensor:
    """raw (B * P_in * 2,) uint8 interleaved cu8; lo_r, lo_i (C, P_in),
    ph_r, ph_i (C, B), a (P_in, K) float32; dc the DC offset -> (C, B, K,
    2) float32.

    A CUDA tensor goes to the kernel (csrc/chan_u8.cu), a CPU tensor to
    channelize_u8_ref; any other device raises."""
    c, p_in = lo_r.shape
    b = ph_r.shape[1] if ph_r.dim() == 2 else -1
    k_out = a.shape[1] if a.dim() == 2 else -1
    if raw.dtype != torch.uint8 or raw.dim() != 1 \
            or raw.numel() != 2 * b * p_in:
        raise ValueError(f"raw must be 1-D uint8 of 2 * B * P_in = "
                         f"{2 * b * p_in} bytes, got {tuple(raw.shape)} "
                         f"{raw.dtype}")
    shapes = ((lo_r, (c, p_in)), (lo_i, (c, p_in)), (ph_r, (c, b)),
              (ph_i, (c, b)), (a, (p_in, k_out)))
    for t, want in shapes:
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"expected float32 {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != raw.device:
            raise ValueError("all tensors must be on one device")
    if raw.device.type == "cpu":
        return channelize_u8_ref(raw, lo_r, lo_i, ph_r, ph_i, a, dc)
    if raw.device.type != "cuda":
        raise ValueError(f"no channelizer kernel for device {raw.device}")
    if not all(t.is_contiguous() for t in (raw, lo_r, lo_i, ph_r, ph_i)):
        raise ValueError("raw, lo and ph must be contiguous")
    if p_in % 4:
        raise ValueError(f"the kernel reads four samples at a time: P_in = "
                         f"{p_in} must be a multiple of 4")
    if raw.data_ptr() % 8:
        raw = raw.clone()                  # a view at an odd byte offset
    from .. import _build

    lib = _build.load()
    starts, weights, slots, pitch, maxlen = _device_windows(a)
    out = torch.empty((c, b, k_out, 2), dtype=torch.float32,
                      device=raw.device)
    # the runtime launches on its current device: make it raw's
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        rc = lib.vdl2_chan_u8(raw.data_ptr(), lo_r.data_ptr(),
                              lo_i.data_ptr(), ph_r.data_ptr(),
                              ph_i.data_ptr(), starts.data_ptr(),
                              weights.data_ptr(), slots.data_ptr(),
                              float(dc), out.data_ptr(), c, b, p_in, k_out,
                              pitch, maxlen, stream)
    if rc:
        raise RuntimeError(
            f"chan_u8 kernel launch failed: CUDA error {rc} at C = {c}, "
            f"B = {b}, P_in = {p_in}, K = {k_out} (error 9: not even one "
            f"window of {maxlen} inputs fits the card's shared memory)")
    global launches
    launches += 1
    return out
