"""Sync scan: (C, T, 2) decimated stream -> (err, fr) at every position.

`sync_scan` launches the CUDA kernel of csrc/sync_scan.cu on a CUDA
tensor and runs the plain PyTorch version on a CPU tensor.  Two modes,
each matching one JAX path operation for operation:

  "stream"  polyphase_filter0 -> atan2 -> running-sum scan relative to
            the first phase (vdlm2dec_tpu/ops/demod.py:115-174)
  "fused"   the same filter -> Cephes atan2 -> two-pass mean / slope /
            residual (vdlm2dec_tpu/ops/pallas_sync.py, the Pallas kernel)

Position t uses the 17 branch-0 filter phases at t-128, t-120, ..., t;
entries t < 128 see zero history (callers mask them).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .._tables import POLY32, SLOPE_NORM, SW32

MODES = ("stream", "fused")

# kernel launches per mode since the last reset_launches()
launches = {mode: 0 for mode in MODES}


def reset_launches() -> None:
    for mode in MODES:
        launches[mode] = 0


def _f32(v: float) -> float:
    """A constant rounded to float32, as the JAX code's weakly typed
    Python floats are when they meet a float32 array."""
    return float(np.float32(v))


PI = _f32(math.pi)
TWO_PI = _f32(2.0 * math.pi)
_TAP0 = [float(v) for v in POLY32[0]]
_SW = [float(v) for v in SW32]
# the kernel takes both tables from host memory, as a kernel argument
_TAPS_HOST = np.ascontiguousarray(POLY32[0], dtype=np.float32)
_SW_HOST = np.ascontiguousarray(SW32, dtype=np.float32)


def polyphase_filter0(y: torch.Tensor) -> torch.Tensor:
    """(C, T, 2) -> (C, T, 2) branch-0 matched filter; output t is the
    17-tap filter over y[t-16 .. t] (zero history before the stream)."""
    t = y.shape[1]
    yp = F.pad(y, (0, 0, 16, 0))
    acc = _TAP0[0] * yp[:, 0:t]
    for j in range(1, 17):
        acc = acc + _TAP0[j] * yp[:, j:j + t]
    return acc


def cephes_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's branch-free float32 atan2 (Cephes atanf
    reduction + degree-4 polynomial), operation for operation."""
    ax, ay = x.abs(), y.abs()
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    z = num / torch.where(den == 0.0, torch.ones_like(den), den)
    red = z > _f32(0.4142135623730950)
    zr = torch.where(red, (z - 1.0) / (z + 1.0), z)
    w = zr * zr
    p = ((_f32(8.05374449538e-2) * w - _f32(1.38776856032e-1)) * w
         + _f32(1.99777106478e-1)) * w - _f32(3.33329491539e-1)
    r = zr + zr * w * p
    r = torch.where(red, r + _f32(0.7853981633974483), r)
    r = torch.where(swap, _f32(1.5707963267948966) - r, r)
    r = torch.where(den == 0.0, torch.zeros_like(r), r)
    r = torch.where(x < 0.0, PI - r, r)
    return torch.where(y < 0.0, -r, r)


def _unwrap_step(pd: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(pd)
    return torch.where(pd > PI, zero - TWO_PI,
                       torch.where(pd < -PI, zero + TWO_PI, zero))


def _windows(phase: torch.Tensor) -> list[torch.Tensor]:
    """The 17 symbol-spaced phase planes minus the sync word."""
    t = phase.shape[1]
    pad = F.pad(phase, (128, 0))
    return [pad[:, 8 * k:8 * k + t] - _SW[k] for k in range(17)]


def sync_scan_stream_ref(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the "stream" mode."""
    f0 = polyphase_filter0(y)
    a = _windows(torch.atan2(f0[..., 1], f0[..., 0]))
    # sums of the unwrapped phases RELATIVE to the first: err/fr are
    # shift-invariant, and small sums avoid the S2 - S0^2/17 cancellation
    a0 = a[0]
    p_prev = a0
    cum = torch.zeros_like(a0)
    s0 = torch.zeros_like(a0)
    s1 = torch.zeros_like(a0)
    s2 = torch.zeros_like(a0)
    for k in range(1, 17):
        pk = a[k]
        cum = cum + _unwrap_step(pk - p_prev)
        pr = (pk - a0) + cum
        s0 = s0 + pr
        s1 = s1 + (k - 8.0) * pr
        s2 = s2 + pr * pr
        p_prev = pk
    # a true division: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    fr = s1 / s1.new_tensor(SLOPE_NORM)
    err = s2 - s0 * s0 * _f32(1.0 / 17.0) - s1 * fr
    return err, fr


def sync_scan_fused_ref(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the "fused" mode."""
    f0 = polyphase_filter0(y)
    a = _windows(cephes_atan2(f0[..., 1], f0[..., 0]))
    pr = [a[0]]
    cum = torch.zeros_like(a[0])
    for k in range(1, 17):
        cum = cum + _unwrap_step(a[k] - a[k - 1])
        pr.append(a[k] + cum)
    m = pr[0]
    for k in range(1, 17):
        m = m + pr[k]
    m = m * _f32(1.0 / 17.0)
    num = torch.zeros_like(m)
    for k in range(17):
        num = num + (pr[k] - m) * float(k - 8)
    fr = num * _f32(1.0 / SLOPE_NORM)
    err = torch.zeros_like(m)
    for k in range(17):
        e = (pr[k] - m) - float(k - 8) * fr
        err = err + e * e
    return err, fr


_REFS = {"stream": sync_scan_stream_ref, "fused": sync_scan_fused_ref}


def sync_scan(y: torch.Tensor, mode: str = "stream"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, T, 2) float32 -> (err, fr), each (C, T) float32.

    A CUDA tensor goes to the kernel (csrc/sync_scan.cu), a CPU tensor to
    the plain version of the mode; any other device raises."""
    if mode not in MODES:
        raise ValueError(f"sync mode must be one of {MODES}, got {mode!r}")
    if y.dim() != 3 or y.shape[-1] != 2 or y.dtype != torch.float32:
        raise ValueError(f"y must be (C, T, 2) float32, got "
                         f"{tuple(y.shape)} {y.dtype}")
    if y.device.type == "cpu":
        return _REFS[mode](y)
    if y.device.type != "cuda":
        raise ValueError(f"no sync kernel for device {y.device}")
    if not y.is_contiguous() or y.data_ptr() % 8:
        raise ValueError("y must be contiguous and 8-byte aligned")
    from .. import _build

    lib = _build.load()
    c, t, _ = y.shape
    err = torch.empty((c, t), dtype=torch.float32, device=y.device)
    fr = torch.empty((c, t), dtype=torch.float32, device=y.device)
    # the runtime launches on its current device: make it y's
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.vdl2_sync_scan(y.data_ptr(), _TAPS_HOST.ctypes.data,
                                _SW_HOST.ctypes.data, err.data_ptr(),
                                fr.data_ptr(), c, t, MODES.index(mode),
                                stream)
    if rc:
        raise RuntimeError(f"sync_scan kernel launch failed: CUDA error {rc}")
    launches[mode] += 1
    return err, fr
