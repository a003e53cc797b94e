"""Times of the two hand-written kernels alone, beside their bounds.

    python3 vdlm2dec_tpu_torch/kernel_times.py              # this tree
    python3 vdlm2dec_tpu_torch/kernel_times.py --tree DIR   # another tree

Run as a file, on one CUDA card.  It times the sync scan (K1, both modes)
and the fused u8 channelizer (K2) through their wrappers
(`ops.sync.sync_scan`, `ops.chan_u8.channelize_u8`) at the shapes the
decode gives them, on seeded random inputs, and prints one JSON line per
case and then the card's name and power limit.  `--tree DIR` takes the
package from the checkout at DIR instead (the wrappers' signatures have
not changed since the kernels were first written), so two versions of a
kernel can be timed on one card, turn about: the other tree first and
last, this tree in between.

Three times per case:
  event_ms  one launch between two CUDA events, median of 20 after 3
            warm-ups.  It contains the wrapper's host work (output
            allocation, the ctypes call), during which the card idles, so
            it is an upper bound of what a caller waits for one launch.
  graph_ms  the kernel's own time: 20 calls of the wrapper captured into
            one CUDA graph, the graph replayed 7 times, the median replay
            over 20 (`graph_min_ms`: the fastest replay).  Every call reads the same input, which stays in the
            L2 cache between launches where it fits (every shape here but
            the 4 s ones).
  cold_ms   as graph_ms, but the 20 calls take turns over copies of the
            input (K1's y, K2's raw bytes) that together hold 128 MiB or
            more, so every launch reads its input from device memory as
            the bound assumes; null where 64 copies are not that much.
and the bound of the contract: the larger of bytes moved once over
3.35 TB/s and float32 operations over 67 TFLOP/s (an H100's published
peaks; the peak counts a fused multiply-add as two operations).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# float32 operations per position of the sync scan: the 17-tap complex
# filter (34 multiplies, 32 adds), the atan2 with its division, the 16
# unwrap-and-sum steps and the line fit
K1_FLOPS = {"stream": 66 + 40 + 16 * 15 + 7, "fused": 66 + 30 + 283}
K1_SHAPES = [(8, 211_848), (8, 212_352), (8, 381_696), (4, 5_376), (1, 130)]
K2_SHAPES = [(8, 2528, 2_000_000), (8, 4544, 2_000_000), (4, 64, 6_000_000),
             (8, 512, 10_000_000)]


def k1_bound(c: int, t: int, mode: str) -> dict:
    """Bound of the sync scan on (c, t, 2): y read once, err and fr
    written once; K1_FLOPS operations per position."""
    nbytes = c * t * (8 + 4 + 4)
    flops = c * t * K1_FLOPS[mode]
    return _bound(nbytes, flops)


def k2_bound(c: int, b: int, p_in: int, k_out: int) -> dict:
    """Bound of the fused u8 channelizer: raw bytes, LO, phases and window
    tables read once, the output written once; per (channel, input) a
    complex mix (6) and two weighted accumulations (4), per input two DC
    subtractions, per output a complex phase (6)."""
    nbytes = (2 * b * p_in + 8 * c * p_in + 8 * c * b + 12 * p_in
              + 8 * c * b * k_out)
    flops = 10 * c * b * p_in + 2 * b * p_in + 6 * c * b * k_out
    return _bound(nbytes, flops)


def _bound(nbytes: int, flops: int) -> dict:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def event_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Median of n CUDA-event timings of one fn() each, in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fns, n: int = 20, replays: int = 7) -> float:
    """ms per call with the host out of the way: n calls, taking turns
    over the callables fns (or the one callable), captured into a CUDA
    graph; the median of `replays` replays over n."""
    return graph_times(fns, n, replays)[0]


def graph_times(fns, n: int = 20, replays: int = 7) -> tuple[float, float]:
    """graph_ms, and the fastest replay over n beside it."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    fns[0]()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()                          # allocator warm-up on the stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(n):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)) / n, float(min(times)) / n


COLD_BYTES = 1 << 27             # more than twice an H100's 50 MB of L2


def cold_ms(call, x: torch.Tensor) -> float | None:
    """graph_ms of call(copy) over enough copies of the input x that no
    launch finds its input in the L2 cache; None where 64 copies are not
    enough (a small x)."""
    nbytes = x.numel() * x.element_size()
    copies = -(-COLD_BYTES // nbytes)
    if copies > 64:
        return None
    xs = [x] + [x.clone() for _ in range(max(copies, 2) - 1)]
    return graph_ms([lambda v=v: call(v) for v in xs])


def _warm(fn) -> dict:
    med, least = graph_times(fn)
    return {"graph_ms": med, "graph_min_ms": least}


def card_string() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def measure(tree: str, only: str | None = None) -> list[dict]:
    """Every case's times (only "k1" or "k2": that kernel's) with the
    package of the checkout at `tree`."""
    sys.path.insert(0, tree)
    from vdlm2dec_tpu_torch._tables import (aggregation_matrix, lo_tables,
                                            period_phases)
    from vdlm2dec_tpu_torch.ops import chan_u8, sync
    from vdlm2dec_tpu_torch.ops.ingest import DC_OFFSET

    out = []
    for c, t in K1_SHAPES if only != "k2" else []:
        rng = np.random.default_rng(c * t)
        y = torch.tensor(rng.normal(size=(c, t, 2)).astype(np.float32) * 30,
                         device="cuda")
        for mode in sync.MODES:
            err, fr = sync.sync_scan(y, mode)
            ref = sync.sync_scan_fused_ref if mode == "fused" \
                else sync.sync_scan_stream_ref
            err_p, fr_p = ref(y)
            out.append(dict(
                kernel=f"sync_scan[{mode}]", shape=[c, t],
                bit_exact=bool(torch.equal(err, err_p)
                               and torch.equal(fr, fr_p)),
                event_ms=event_ms(lambda: sync.sync_scan(y, mode)),
                **_warm(lambda: sync.sync_scan(y, mode)),
                cold_ms=cold_ms(lambda v: sync.sync_scan(v, mode), y),
                **k1_bound(c, t, mode)))
    for c, b, fs in K2_SHAPES if only != "k1" else []:
        rng = np.random.default_rng(c * b)
        sdrclk = fs // 4000
        offs = tuple(25_000.0 * (3 * i - 7) for i in range(c))
        lo, _ = lo_tables(offs, fs, sdrclk, True)
        ph = period_phases(offs, fs, sdrclk, True, b, 5)
        a = aggregation_matrix(sdrclk)
        raw = rng.integers(0, 256, b * 4 * sdrclk * 2).astype(np.uint8)
        args = [torch.tensor(np.ascontiguousarray(v), device="cuda")
                for v in (raw, lo.real, lo.imag, ph.real, ph.imag, a)]
        shape = [c, b, 4 * sdrclk]
        try:
            y = chan_u8.channelize_u8(*args, DC_OFFSET)
        except RuntimeError as exc:        # a shape this tree's kernel refuses
            out.append(dict(kernel="chan_u8", shape=shape, error=str(exc)))
            continue
        y_p = chan_u8.channelize_u8_ref(*args, DC_OFFSET)
        out.append(dict(
            kernel="chan_u8", shape=shape,
            max_abs_err=float((y - y_p).abs().max()),
            event_ms=event_ms(lambda: chan_u8.channelize_u8(*args, DC_OFFSET)),
            **_warm(lambda: chan_u8.channelize_u8(*args, DC_OFFSET)),
            cold_ms=cold_ms(lambda v: chan_u8.channelize_u8(
                v, *args[1:], DC_OFFSET), args[0]),
            **k2_bound(c, b, 4 * sdrclk, a.shape[1])))
    return out


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(here),
                    help="checkout whose vdlm2dec_tpu_torch is timed "
                         "(default: the one this file is in)")
    ap.add_argument("--only", choices=("k1", "k2"),
                    help="time one kernel only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card visible to torch", file=sys.stderr)
        return 2
    # run as a file, sys.path[0] is the package's own directory: its module
    # names must not shadow top-level ones
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    tree = os.path.abspath(args.tree)
    for res in measure(tree, args.only):
        print(json.dumps(dict(tree=tree, **res)), flush=True)
    print(card_string())
    return 0


if __name__ == "__main__":
    sys.exit(main())
