"""One run of one cell: capture, set-up, window, comparison, result line."""
from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np
import torch

from . import cells, drive, gen
from .reference import DEMOD_RATE, Judge, slope_gaps, tally, unsyncable
from .trace import Tracer

# every number compared, with its limit:
#   missed_wrong_extra  the configuration states that every burst that
#       the sync rule catches (reference.unsyncable) comes back exactly
#       once and exactly right, and that nothing else is printed: bursts
#       missed or wrong and lines that belong to no burst are counted
#       together, and none may be
#   sync_df_gap_hz  the configuration computes in float32: the widest gap
#       (Hz) between the frequency offset the program yielded for a burst
#       and the reference's float64 sync fit at the same trigger, over a
#       sample of the window's bursts (limit: PERF.md, section 2)
LIMITS = {"missed_wrong_extra": 0, "sync_df_gap_hz": 0.01}
SOFT_SAMPLE = 1024               # bursts a run holds against the float64 fit


def _no_margin(geometry):
    """Control: a block's right margin left out, so a burst that runs past
    the end of its block's core is cut there."""
    def geom(p_in, p_out, fs, max_symbols, block_seconds, align=1):
        lmarg_p, _rmarg_p, core_p, _total_p = geometry(
            p_in, p_out, fs, max_symbols, block_seconds, align)
        total_p = lmarg_p + core_p
        total_p += (-total_p) % align
        return lmarg_p, total_p - lmarg_p - core_p, core_p, total_p
    return geom


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             control: str | None = None, bench_dir: str = cells.BENCH_DIR) -> dict:
    from vdlm2dec_tpu_torch import pipeline as pl
    from vdlm2dec_tpu_torch.metrics import PipelineMetrics

    t_start = time.monotonic() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = cells.config(spec, cell["config"], root=os.path.dirname(bench_dir))
    tr = cells.traffic(cell["traffic"], bench_dir)
    t_ready = time.monotonic()
    cap = gen.make_capture(cfg, tr, seed, device)
    t_capture = time.monotonic()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    saved = pl.stream_geometry
    if control == "no_margin":
        pl.stream_geometry = _no_margin(pl.stream_geometry)
    try:
        pipe = pl.Pipeline(drive.pipeline_config(cfg, control), device)
        t_pipe = time.monotonic()
        pipe.metrics = PipelineMetrics()
        rec = drive.Record(cell, cfg, tr)
        rec.k1_shape = drive.k1_shape(pipe, float(cfg["block_seconds"]))
        tracer = Tracer(trace, device.type)
        run = drive.run_live if tr["mode"] == "live" else drive.run_file
        sink, due = run(pipe, cap, rec, seconds, tracer, t_start, device)
        rec.overflow = pipe.metrics.candidates_overflow
    finally:
        pl.stream_geometry = saved
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program is freed
    t_ref = time.monotonic()
    live = tr["mode"] == "live"
    period = int(round(cap.seconds * DEMOD_RATE)) if live else 1 << 40
    judge = Judge(cap.bursts, cap.freqs_hz, drive.STATION, period)
    # bursts that vdlm2dec's sync rule cannot catch are not owed
    excused = set(unsyncable(cap.raw, cap.fmt, cap.fs, cap.fc_hz, cap.freqs_hz, cap.bursts))
    due = [d for d in due if d[1] not in excused]
    rec.due_t = {k: v for k, v in rec.due_t.items() if k[0] not in excused}
    rec.tally = tally(judge, [(s, line) for s, _t, line in sink.lines()], due, excused)
    if live:
        rec.latencies_ms = drive.live_latencies(judge, sink, rec)
    gaps = slope_gaps(cap.raw, cap.fmt, cap.fs, cap.fc_hz, cap.freqs_hz, rec.soft,
                      SOFT_SAMPLE, seed)
    reference_s = time.monotonic() - t_ref

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cells.metrics_of(spec, cell["name"], kind):
        v = cells.reader(m["name"], bench_dir)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    t = rec.tally
    failed = t["missed"] + t["wrong"]
    # no burst to hold against the fit reads as an infinite gap: not correct
    checks = {"missed_wrong_extra": failed + t["extra"],
              "sync_df_gap_hz": float(gaps.max()) if len(gaps) else float("inf")}
    correct = t["attempted"] > 0 and all(checks[k] <= LIMITS[k] for k in LIMITS)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": t["attempted"], "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    t["failures"] = [
        {"stream": k[0], "burst": k[1], "repeat": k[2], "lines": n,
         "chan": cap.bursts[k[1]].chan, "start": cap.bursts[k[1]].start,
         "end": cap.bursts[k[1]].end, "kind": cap.bursts[k[1]].kind,
         "imp": cap.bursts[k[1]].imp} for k, n in t["failures"]]
    out["info"] = {"tally": t, "blocks": rec.blocks, "sixths": _sixths(rec, seconds),
                   "sync_df_gaps_hz": {"n": len(gaps),
                                       "median": float(np.median(gaps)) if len(gaps) else None},
                   "samples": rec.samples,
                   "bursts": rec.bursts, "bursts_framed": rec.bursts_framed,
                   "candidates_overflow": rec.overflow,
                   "setup_parts_s": {"start": t_ready - t_start,
                                     "capture": t_capture - t_ready,
                                     "pipeline": t_pipe - t_capture,
                                     "warm_and_lead": t_start + rec.setup_s - t_pipe},
                   "reference_s": reference_s,
                   "capture_bursts": len(cap.bursts), "feed": rec.feed,
                   "unsyncable": [{"burst": i, "chan": cap.bursts[i].chan,
                                   "start": cap.bursts[i].start} for i in sorted(excused)],
                   "control": control}
    out["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]} for k in LIMITS}
    return out


def _sixths(rec, seconds: float) -> dict:
    """The counted blocks by sixth of the window, and the host's account
    of them (drive.HostAccount), summed a sixth: a steady rate reads flat,
    and what moved with it shows beside it."""
    keys = ("next_s", "output_s", "output_cpu_s", "gc_s", "nivcsw", "process_cpu_s")
    out = {"blocks": [0] * 6, **{k: [0.0] * 6 for k in keys}}
    for t_done, host in zip(rec.block_done, rec.block_host):
        i = min(5, int(6 * t_done / seconds))
        out["blocks"][i] += 1
        for k, v in zip(keys, host):
            out[k][i] += v
    for k in keys:
        out[k] = [round(v, 4) for v in out[k]]
    return out


def emit(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    n = len(result.get("info", {}).get("unsyncable", ()))
    print(f"not owed (the sync rule cannot catch them): {n} bursts", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
