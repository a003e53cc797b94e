"""Multi-process scaling of the port's worker, one worker a card.

    python -m vdlm2dec_tpu_torch.scaling_bench                # every card
    python -m vdlm2dec_tpu_torch.scaling_bench --processes 1,2,4 --out s.json
    python -m vdlm2dec_tpu_torch.scaling_bench --device cpu --processes 1,2 \
        --seconds 2 --repeats 1

The twin of tools/scaling_bench.py over the port's
parallel.multihost.launch_local.  It decodes one fixed capture
(stimulus.make_capture, cu8) with the windowed worker (--block-seconds,
--timing) at P = 1, 2, ... processes.  Worker p holds --cards-per-worker k
cards, cuda:{p k} .. cuda:{p k + k - 1}, one time shard a card, and is
pinned with taskset to an equal share of this host's cores, so that host
work does not contend; the halos travel over NCCL when no two workers
share a card, else over gloo (P workers on fewer cards than P k: marked
`shared_card` and never an efficiency).  --device cpu puts every worker's
shards on the CPU, over gloo.

Window 0 of every run carries the warm-up and is excluded; throughput is
the capture samples of the timed windows over their wall seconds in
process 0 (the exchange keeps the processes in step).  The repeats
interleave (rep 0 of every P, then rep 1, ...) so that drift cancels in
the paired efficiency: rep i of P against rep i of P = 1 of the same
window size.  The ideal at P is P k cards times the P = 1 rate a card;
each point reports best, median and worst Msps, the efficiency of its
best (`efficiency_vs_1proc`), of its worst against P = 1's best
(`efficiency_worst`) and the paired efficiencies.

The gate: the FRAME lines are the same set at every P, window size and
repeat, and they are the synthesized truth inside the decoded span.  The
record goes to stdout (last line) and, with --out, to that file; exit code
0 iff the gate holds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import Counter

import torch

from . import stimulus
from ._tables import period_for
from .bench import device_card
from .parallel.multihost import launch_local


def synth_capture(path: str, fs: int, channels: int, seconds: float):
    """The fixed stimulus as cu8 at path; returns (freqs, fc, truth)."""
    wide, freqs, fc, truth = stimulus.make_capture(fs, channels, seconds)
    stimulus.to_u8(wide).tofile(path)
    return freqs, fc, truth


def worker_devices(processes: int, cards_per_worker: int, device: str,
                   cards: int) -> tuple[list[str], bool]:
    """Each worker's comma list of devices and whether two workers share a
    card: worker p takes cards p k .. p k + k - 1, modulo the cards there
    are; on the CPU every worker's shards are on "cpu"."""
    k = cards_per_worker
    if device == "cpu":
        return [",".join(["cpu"] * k)] * processes, False
    lists = [",".join(f"cuda:{(p * k + i) % cards}" for i in range(k))
             for p in range(processes)]
    return lists, processes * k > cards


def core_sets(processes: int) -> list[str] | None:
    """An equal share of this process's cores a worker, as taskset lists;
    None when there are fewer cores than workers."""
    cores = sorted(os.sched_getaffinity(0))
    per = len(cores) // processes
    if per == 0:
        return None
    return [",".join(map(str, cores[p * per:(p + 1) * per]))
            for p in range(processes)]


def frame_key(line: str) -> tuple[int, bytes]:
    """A FRAME line's channel and content (flag, FCS and closing flag
    off), as the stimulus truth records it."""
    _tag, chan, _t0, hexed = line.split()
    return int(chan), bytes.fromhex(hexed)[1:-3]


def run_p(processes: int, capture: str, freqs_mhz: list[float], fc: int,
          block_seconds: float, cards_per_worker: int, device: str,
          cards: int, timeout: float, dispatch_depth: int = 2) -> dict:
    """One job of `processes` workers over the capture: its rate, the
    per-phase host seconds of process 0 and its FRAME lines."""
    devices, shared = worker_devices(processes, cards_per_worker, device,
                                     cards)
    backend = "gloo" if device == "cpu" or shared else "nccl"
    cpu_sets = core_sets(processes)
    worker_args = [
        "--iq", capture, "--fc", str(fc),
        "--block-seconds", str(block_seconds),
        "--max-symbols", "512", "--timing",
        "--dispatch-depth", str(dispatch_depth),
        # capacity sized for the dense stimulus (~76 bursts per 1 s
        # window; the worker defaults overflow and drop bursts, and the
        # loss would differ by P because packed slots are per process)
        "--max-candidates", "32", "--max-out", "256",
    ] + [str(f) for f in freqs_mhz]
    t0 = time.monotonic()
    outs = launch_local(processes, worker_args,
                        local_devices=cards_per_worker, timeout=timeout,
                        cpu_sets=cpu_sets, device=devices, backend=backend)
    wall = time.monotonic() - t0
    frames = set()
    stats = None
    for out in outs:
        for line in out.splitlines():
            if line.startswith("FRAME "):
                frames.add(line)
            elif line.startswith("STATS ") and stats is None:
                stats = json.loads(line[6:])
    if stats is None:
        raise RuntimeError("no STATS line (need >=2 windows for timing)")
    samples = stats["timed_windows"] * stats["global_samples_per_window"]
    return {
        "processes": processes,
        "cards_per_worker": cards_per_worker,
        "devices": devices,
        "backend": backend,
        "shared_card": shared,
        "cpu_sets": cpu_sets,
        "block_seconds": block_seconds,
        "dispatch_depth": dispatch_depth,
        "timed_windows": stats["timed_windows"],
        "timed_s": stats["timed_s"],
        "msps": samples / stats["timed_s"] / 1e6,
        "total_wall_s": wall,
        "phase_s": stats.get("phase_s", {}),
        "frames": sorted(frames),
    }


def summarize(samples_by_p: dict) -> list[dict]:
    """Per P of one window size: the best run's record with the worst
    and median Msps, and the efficiencies against P = 1 (none for a
    shared card, or without a P = 1 point)."""
    runs = []
    base_runs = samples_by_p.get(1, [])
    top = max(base_runs, key=lambda r: r["msps"], default=None)
    for p, samples in samples_by_p.items():
        ranked = sorted(samples, key=lambda r: r["msps"])
        best = dict(ranked[-1])
        del best["frames"]
        best["msps_worst"] = ranked[0]["msps"]
        best["msps_median"] = ranked[len(ranked) // 2]["msps"]
        best["msps_runs"] = [r["msps"] for r in samples]
        if p != 1 and top is not None and not best["shared_card"]:
            def ideal(rb, r):
                per_card = rb["msps"] / (rb["processes"]
                                         * rb["cards_per_worker"])
                return per_card * r["processes"] * r["cards_per_worker"]

            best["efficiency_paired"] = sorted(
                r["msps"] / ideal(rb, r) for r, rb in zip(samples, base_runs))
            best["efficiency_vs_1proc"] = best["msps"] / ideal(top, best)
            best["efficiency_worst"] = best["msps_worst"] / ideal(top, best)
        runs.append(best)
    return runs


def default_processes(cards: int, cards_per_worker: int) -> list[int]:
    """1, 2, 4, ... up to the workers the cards hold, and that count."""
    n = max(1, cards // cards_per_worker)
    out = [p for p in (1, 2, 4, 8, 16, 32) if p <= n]
    return out if out[-1] == n else out + [n]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--fs", type=int, default=2_000_000)
    ap.add_argument("--block-seconds", default="1.0",
                    help="comma list of window sizes to sweep")
    ap.add_argument("--processes", default=None,
                    help="comma list (default: 1, 2, 4, ... up to the "
                         "cards / --cards-per-worker)")
    ap.add_argument("--cards-per-worker", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the workers' shards on the cards, or all on the "
                         "CPU")
    ap.add_argument("--dispatch-depth", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--repeats", type=int, default=3,
                    help="runs per (P, window) point, interleaved")
    ap.add_argument("--out", default=None,
                    help="also write the record to this file")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scaling_bench: no CUDA card visible to torch (--device cpu "
              "runs the workers on the CPU)", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    if args.processes:
        plist = [int(x) for x in args.processes.split(",")]
    elif args.device == "cpu":
        plist = [1, 2]
    else:
        plist = default_processes(cards, args.cards_per_worker)
    wlist = [float(x) for x in args.block_seconds.split(",")]
    with tempfile.TemporaryDirectory(prefix="vdl2_scaling_") as tmp:
        capture = os.path.join(tmp, "scaling.cu8")
        freqs, fc, truth = synth_capture(capture, args.fs, args.channels,
                                         args.seconds)
        n_samples = os.path.getsize(capture) // 2
        print(f"# capture: {args.seconds}s x {args.channels}ch, "
              f"{len(truth)} bursts; cards={cards}, P={plist}",
              file=sys.stderr)
        runs = []
        frame_sets = []
        for bs in wlist:
            samples_by_p: dict = {p: [] for p in plist}
            for rep in range(args.repeats):
                for p in plist:
                    r = run_p(p, capture, [f / 1e6 for f in freqs], fc, bs,
                              args.cards_per_worker, args.device, cards,
                              args.timeout, args.dispatch_depth)
                    print(f"# P={p} w={bs}s rep{rep}: {r['msps']:.3f} Msps "
                          f"over {r['timed_windows']} windows ({r['backend']}"
                          f", {len(r['frames'])} frames)", file=sys.stderr,
                          flush=True)
                    frame_sets.append(set(r["frames"]))
                    samples_by_p[p].append(r)
            runs += summarize(samples_by_p)

    # correctness: identical frame sets at every process count, window
    # size and repeat (windowing is exact overlap-save; ownership is
    # trigger-position based), and they are the truth in the decoded span
    identical = all(fs_ == frame_sets[0] for fs_ in frame_sets)
    p_in, p_out = period_for(args.fs // 4000)
    span84 = n_samples // p_in * p_out
    want = Counter((c, b) for c, b, p0, n in truth if p0 + n <= span84)
    got = Counter(frame_key(ln) for ln in frame_sets[0])
    out = {
        "capture_seconds": args.seconds,
        "channels": args.channels,
        "bursts": len(truth),
        "device": args.device,
        "cards": cards,
        "card": device_card(args.device),
        "cores_available": len(os.sched_getaffinity(0)),
        "dispatch_depth": args.dispatch_depth,
        "frames_identical_across_runs": identical,
        "recall": f"{sum((want & got).values())}/{sum(want.values())}",
        "frames_beyond_truth": sum((got - want).values()),
        "runs": runs,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if identical and got == want else 1


if __name__ == "__main__":
    sys.exit(main())
