"""Recall soak: dense multi-channel traffic through the port's decoder,
held to the synthesized truth and, where it is built, to the compiled
reference binary.

    python -m vdlm2dec_tpu_torch.soak_compare                    # clean
    python -m vdlm2dec_tpu_torch.soak_compare --scenario cfo --stream
    python -m vdlm2dec_tpu_torch.soak_compare --scenario airspy --rate 6000000
    python -m vdlm2dec_tpu_torch.soak_compare --seconds 2 --device cpu

The twin of tools/soak_compare.py, with its scenarios, flags, capacities
and the same capture for the same scenario (one rng stream, seed 42):

  clean   2 ch x 10 s, clean bursts
  cfo     8 ch x 30 s, per-burst CFO +-2 ppm of the RF channel (~ +-274 Hz),
          12 dB level spread, random phase and fractional timing
  airspy  4 ch x 30 s real f32 capture at 5 Msps (R2 chain; --rate 6000000
          for the Mini), through the real_input pipeline

--dft / --pfb pick the residue-space channelizers (default matmul), --fused
/ --stream the sync mode (default "xla"), --bf16 the channelizer operands.
The capture is decoded through Pipeline.stream_wideband_u8 in 4 s blocks on
--device (default the card).

The gate is the truth: every transmitted burst must come back on its own
frequency with its text, nothing else may decode, and no sync candidate
may be dropped for want of a decode slot (a dropped one raises with the
count).  The compiled reference (tests/refshim/ref_shim, ref_shim_air for
airspy) runs only where it has been built, and then the port must decode
every frame it decodes; its sources are not in this repository, so
elsewhere the run says so and records "reference": null, and the truth
alone decides.  Exit code 0 iff the gate holds.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

from . import framegen as fg
from . import modulator as mod
from ._tables import PipelineConfig
from .bench import device_card
from .host.decoder import FrameDecoder
from .host.output import OutputConfig
from .io.sdr import CaptureReader, write_capture
from .metrics import PipelineMetrics
from .pipeline import Pipeline

TWO_PI = 2 * np.pi
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SHIM = os.path.join(ROOT, "tests", "refshim", "ref_shim")
REF_SHIM_AIR = os.path.join(ROOT, "tests", "refshim", "ref_shim_air")
SCENARIOS = ("clean", "cfo", "airspy")


def synth(scenario: str, fs: int, fc: int, freqs: list[int], seconds: int,
          rng, impair_ppm: float = 0.0, spread_db: float = 0.0,
          truth: list | None = None):
    """Complex wideband capture + burst count.  Impairments are per
    burst: CFO uniform +-ppm of the RF channel, level uniform in
    [-spread_db, 0] above the base amplitude, random carrier phase and
    fractional-sample timing.

    truth (optional list) receives one record per burst (channel index,
    frequency, position/length at 84 kHz, text and the drawn impairments)
    without consuming any extra rng draws, so a recorded run is
    sample-identical to an unrecorded one."""
    total = fs * seconds
    total_bb = 84_000 * seconds
    wide = np.zeros(total, dtype=np.complex128)
    n_tx = 0
    for ci, f in enumerate(freqs):
        bb = np.zeros(total_bb, dtype=np.complex128)
        pos = 1000 + 7000 * ci
        while pos + 4000 < total_bb:
            txt = f"SOAK {ci} {pos}"
            content = fg.acars_frame(
                text=txt, label="Q0",
                from_addr=fg.AIRCRAFT | (0x100000 + ci * 4096 + (pos & 0xFFF)),
            )
            plan = mod.make_burst([content])
            if impair_ppm or spread_db:
                imp = dict(
                    cfo_hz=float(rng.uniform(-impair_ppm, impair_ppm)
                                 * f / 1e6),
                    phase0=float(rng.uniform(0, TWO_PI)),
                    timing_frac=float(rng.uniform(0, 1)),
                    amplitude=float(10 ** (rng.uniform(-spread_db, 0) / 20)),
                )
                burst = mod.synthesize_baseband(plan, start=0, **imp)
            else:
                imp = {}
                burst = mod.synthesize_baseband(plan, start=0)
            if pos + len(burst) > total_bb:
                break
            bb[pos: pos + len(burst)] += burst
            n_tx += 1
            if truth is not None:
                truth.append({"ci": ci, "freq": f, "pos": pos,
                              "len": len(burst), "text": txt, **imp})
            pos += len(burst) + int(rng.integers(3000, 20000))
        wide += mod.upsample_to_wideband(bb, fs, f - fc, total=total)
    return wide, n_tx


def synth_real(fs: int, f0: float, freqs: list[int], seconds: int, rng,
               impair_ppm: float, spread_db: float,
               truth: list | None = None):
    """Airspy-chain real capture (channel energy at fo = f - f0 with the
    conjugate image at -fo; offsets chosen with distinct |fo|).  truth as
    in synth."""
    total = fs * seconds
    total_bb = 84_000 * seconds
    real_sig = np.zeros(total, dtype=np.float64)
    ratio = fs / 84_000
    n_tx = 0
    for ci, f in enumerate(freqs):
        bb = np.zeros(total_bb, dtype=np.complex128)
        pos = 1000 + 7000 * ci
        while pos + 4000 < total_bb:
            txt = f"SOAK {ci} {pos}"
            content = fg.acars_frame(
                text=txt, label="Q0",
                from_addr=fg.AIRCRAFT | (0x100000 + ci * 4096 + (pos & 0xFFF)),
            )
            plan = mod.make_burst([content])
            imp = dict(
                cfo_hz=float(rng.uniform(-impair_ppm, impair_ppm) * f / 1e6),
                phase0=float(rng.uniform(0, TWO_PI)),
                timing_frac=float(rng.uniform(0, 1)),
                amplitude=float(10 ** (rng.uniform(-spread_db, 0) / 20)),
            )
            burst = mod.synthesize_baseband(plan, start=0, **imp)
            if pos + len(burst) > total_bb:
                break
            bb[pos: pos + len(burst)] += burst
            n_tx += 1
            if truth is not None:
                truth.append({"ci": ci, "freq": f, "pos": pos,
                              "len": len(burst), "text": txt, **imp})
            pos += len(burst) + int(rng.integers(3000, 20000))
        tt = np.arange(total) / ratio
        i0 = np.clip(np.floor(tt).astype(int), 0, len(bb) - 2)
        frac = tt - i0
        up = bb[i0] * (1 - frac) + bb[i0 + 1] * frac
        fo = f - f0
        real_sig += 2.0 * np.real(
            up * np.exp(1j * TWO_PI * fo / fs * np.arange(total)))
    return real_sig, n_tx


def make_capture(scenario: str, path: str, seconds: int | None = None,
                 channels: int | None = None, rate: int = 5_000_000,
                 truth: list | None = None) -> dict:
    """The scenario's capture written to path (cu8, or f32 for airspy), as
    the JAX tool makes it: its plan (fs, fc, freqs, seconds, real_input,
    tx) and the reference binary's command line."""
    rng = np.random.default_rng(42)
    if scenario == "airspy":
        fs = rate
        seconds = seconds or 30
        fc = 136_000_000 - fs // 4
        f0 = fc + fs // 4
        nch = channels or 4
        # distinct |fo| (drive_formats.synth_real: the synthetic real
        # model has a conjugate image at -fo)
        offs = (-1_200_000, -500_000, 250_000, 900_000,
                -1_500_000, 650_000, -850_000, 1_100_000)[:nch]
        freqs = [int(round((f0 + o) / 25_000)) * 25_000 for o in offs]
        sig, n_tx = synth_real(fs, f0, freqs, seconds, rng, impair_ppm=2.0,
                               spread_db=12.0, truth=truth)
        sig = sig * 30 + rng.normal(size=len(sig))
        sig.astype(np.float32).tofile(path)
        ref_cmd = ([REF_SHIM_AIR, path, str(fc)]
                   + [f"{f / 1e6:.6f}" for f in freqs] + ["-J", f"-r{fs}"])
    elif scenario in ("clean", "cfo"):
        fs = 2_000_000
        seconds = seconds or (10 if scenario == "clean" else 30)
        fc = 136_900_000 if scenario == "clean" else 136_775_000
        if scenario == "clean":
            freqs = [136_725_000, 136_975_000][: channels or 2]
        else:
            freqs = [136_600_000 + 50_000 * i for i in range(channels or 8)]
        ppm = 0.0 if scenario == "clean" else 2.0
        spread = 0.0 if scenario == "clean" else 12.0
        wide, n_tx = synth(scenario, fs, fc, freqs, seconds, rng,
                           impair_ppm=ppm, spread_db=spread, truth=truth)
        wide *= 40.0
        wide += rng.normal(size=len(wide)) + 1j * rng.normal(size=len(wide))
        write_capture(path, wide, "cu8")
        ref_cmd = ([REF_SHIM, path, str(fc)]
                   + [f"{f / 1e6:.6f}" for f in freqs] + ["-J"])
    else:
        raise ValueError(f"scenario must be one of {SCENARIOS}")
    return dict(scenario=scenario, fs=fs, fc=fc, freqs=freqs, seconds=seconds,
                real_input=scenario == "airspy", tx=n_tx, ref_cmd=ref_cmd)


def pipeline_config(cap: dict, chan_impl: str = "matmul",
                    sync_impl: str = "xla",
                    compute: str = "f32") -> PipelineConfig:
    """The JAX tool's PipelineConfig for a capture (make_capture's
    record): 1024 symbols, 64 candidates a channel and max(96, 56 C)
    decode slots (~25 bursts a channel per 4 s block at this density, x2
    for junk triggers, which take slots too)."""
    return PipelineConfig(
        freqs_hz=[float(f) for f in cap["freqs"]], fs=cap["fs"],
        fc_hz=float(cap["fc"]), real_input=cap["real_input"],
        max_symbols=1024, max_candidates=64, chan_impl=chan_impl,
        sync_impl=sync_impl, compute=compute,
        max_out=max(96, 56 * len(cap["freqs"])))


def decode(pipe: Pipeline, path: str, real_input: bool) -> list[dict]:
    """The capture through stream_wideband_u8 in 4 s blocks -> the JSON
    records FrameDecoder prints.  Raises if a sync candidate was dropped
    for want of a decode slot."""
    buf = io.StringIO()
    dec = FrameDecoder(OutputConfig(verbose=0, jsonout=True, logfile=buf))
    pipe.metrics = PipelineMetrics()
    if real_input:
        stream = pipe.stream_wideband_u8(CaptureReader(path, "f32real").raw,
                                         block_seconds=4.0, fmt="f32real")
    else:
        stream = pipe.stream_wideband_u8(np.fromfile(path, dtype=np.uint8),
                                         block_seconds=4.0)
    for bursts in stream:
        for b in bursts:
            dec.process_burst(b)
    overflow = pipe.metrics.candidates_overflow
    if overflow:
        raise RuntimeError(f"{overflow} sync candidates dropped: decode slots "
                           f"exhausted (max_out={pipe._max_out()})")
    return [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.strip()]


def record_key(o: dict) -> tuple:
    """A frame record's key, as the JAX tool's: frequency as the output
    prints it, text, the sender's address."""
    return (f"{float(o['freq']):.3f}", (o.get("text") or "").strip(),
            o.get("hex"))


def truth_keys(truth: list) -> Counter:
    """The keys that the bursts of synth's truth must decode to: each on
    its own frequency, from the address synth gave it."""
    return Counter((f"{t['freq'] / 1e6:.3f}", t["text"],
                    f"{0x100000 + t['ci'] * 4096 + (t['pos'] & 0xFFF):06X}")
                   for t in truth)


def run_reference(cmd: list[str]):
    """The compiled reference's records, or None where it is not built."""
    if not os.access(cmd[0], os.X_OK):
        return None
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    return [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.strip().startswith("{")]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", default="clean", choices=SCENARIOS)
    ap.add_argument("--seconds", type=int, default=None)
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--rate", type=int, default=5_000_000,
                    help="airspy scenario sample rate (5000000 R2 / "
                         "6000000 Mini)")
    ap.add_argument("--dft", action="store_true")
    ap.add_argument("--pfb", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--stream", action="store_true",
                    help="sync_impl=stream (the CLI's default)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decode (cuda, cpu)")
    ap.add_argument("--json", default=None, help="write a summary JSON")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    truth: list = []
    with tempfile.TemporaryDirectory(prefix="vdl2_soak_") as tmp:
        path = os.path.join(tmp, "soak.f32" if args.scenario == "airspy"
                            else "soak.cu8")
        t = time.perf_counter()
        cap = make_capture(args.scenario, path, args.seconds, args.channels,
                           args.rate, truth)
        synth_s = time.perf_counter() - t
        print(f"capture: {args.scenario}, {cap['seconds']}s x "
              f"{len(cap['freqs'])}ch, {cap['tx']} bursts", flush=True)
        ref = run_reference(cap["ref_cmd"])
        if ref is None:
            print(f"reference: not built ({cap['ref_cmd'][0]} is missing: "
                  "its sources are not in this repository); the truth "
                  "decides", flush=True)
        else:
            print(f"reference decoded: {len(ref)}", flush=True)

        impl = "dft" if args.dft else ("pfb" if args.pfb else "matmul")
        sync_impl = ("fused" if args.fused
                     else "stream" if args.stream else "xla")
        compute = "bf16" if args.bf16 else "f32"
        pipe = Pipeline(pipeline_config(cap, impl, sync_impl, compute),
                        device=args.device)
        t = time.perf_counter()
        ours = decode(pipe, path, cap["real_input"])
        dt = time.perf_counter() - t
    print(f"ours decoded: {len(ours)} in {dt:.1f}s", flush=True)

    want, got = truth_keys(truth), Counter(map(record_key, ours))
    missed, extra = want - got, got - want
    n_samples = cap["fs"] * cap["seconds"]
    summary = {"scenario": args.scenario, "seconds": cap["seconds"],
               "channels": len(cap["freqs"]), "fs": cap["fs"],
               "tx": cap["tx"], "ours": len(ours),
               "recall": f"{sum((want & got).values())}/{sum(want.values())}",
               "missed": sum(missed.values()), "extra": sum(extra.values()),
               "candidates_overflow": pipe.metrics.candidates_overflow,
               "sync_candidates": pipe.metrics.sync_candidates,
               "impl": impl, "sync_impl": sync_impl, "compute": compute,
               "device": args.device, "card": device_card(args.device),
               "synth_s": synth_s, "decode_s": dt,
               "msps": n_samples / dt / 1e6, "reference": None}
    ok = not missed and not extra and cap["tx"] == sum(want.values())
    print(f"tx={cap['tx']} ours={len(ours)} recall={summary['recall']} "
          f"missed={summary['missed']} extra={summary['extra']}", flush=True)
    print("missed:", sorted(missed)[:5], flush=True)
    print("extra:", sorted(extra)[:5], flush=True)
    if ref is not None:
        kr, ko = set(map(record_key, ref)), set(got)
        superset = kr <= ko
        summary["reference"] = {"ref": len(kr), "common": len(kr & ko),
                                "strict_superset": superset}
        print(f"ref={len(kr)} common={len(kr & ko)} "
              f"strict_superset={superset}", flush=True)
        print("only-ref:", sorted(kr - ko)[:5], flush=True)
        ok = ok and superset
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
