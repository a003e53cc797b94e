"""Drive every raw capture format through the CLI at production shape.

    python -m vdlm2dec_tpu_torch.drive_formats            # on the card
    python -m vdlm2dec_tpu_torch.drive_formats --device cpu --seconds 2 \
        --channels 2 --formats cu8,f32real5 --cli-args "--max-rows 2"

The twin of tools/drive_formats.py.  It synthesizes a multi-burst ACARS
capture per format (cu8 / cs16 / cf32 at 2 Msps complex, f32real at the
Airspy Mini's 6 Msps and the R2's 5 Msps real chains, air.c:123-141), runs
the port's real CLI (`python -m vdlm2dec_tpu_torch.cli ... -J --device D`)
on it as a process, at the CLI's production shape (8-row demod window, 4 s
streaming blocks), and checks that every synthesized burst's text comes
back.  One JSON line per format, with the card's name and power limit;
exit code 0 when every format decodes every text and its CLI exits 0.
The captures live in a temporary directory of their own.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import framegen as fg
from . import modulator as mod
from .bench import device_card
from .constants import DEMOD_RATE
from .io.sdr import write_capture

TWO_PI = 2 * np.pi
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = ("cu8", "cs16", "cf32", "f32real5", "f32real6")
REAL_RATES = {"f32real5": 5_000_000, "f32real6": 6_000_000}


def synth_complex(path: str, fmt: str, fs: int, seconds: float,
                  n_channels: int = 8):
    """Multi-channel ACARS capture in a complex format; returns (freqs,
    fc, texts)."""
    rng = np.random.default_rng(7)
    freqs = [136_600_000 + 50_000 * i for i in range(n_channels)]
    fc = 136_775_000
    total = int(fs * seconds)
    total_bb = int(DEMOD_RATE * seconds)
    wide = np.zeros(total, dtype=np.complex128)
    texts = []
    for ci, f in enumerate(freqs):
        bb = np.zeros(total_bb, dtype=np.complex128)
        pos = 700 + 1131 * ci
        k = 0
        while pos + 6000 < total_bb:
            text = f"{fmt.upper()}C{ci}N{k:02d}"
            content = fg.acars_frame(text=text, label="Q0")
            burst = mod.synthesize_baseband(
                mod.make_burst([content]), start=0, total=None,
                cfo_hz=float(rng.uniform(-400, 400)),
                phase0=float(rng.uniform(0, TWO_PI)),
                timing_frac=float(rng.uniform(0, 1)),
                amplitude=float(8.0 * 10 ** (rng.uniform(-18, 0) / 20)),
            )
            if pos + len(burst) > total_bb:
                break
            bb[pos: pos + len(burst)] += burst
            texts.append(text)
            # gap keeps <=28 bursts/channel per 4 s window: the CLI's
            # per-channel sync-candidate capacity is 32/block
            pos += len(burst) + int(rng.integers(6500, 16000))
            k += 1
        wide += mod.upsample_to_wideband(bb, fs, f - fc, total=total)
    noise = rng.normal(size=total) + 1j * rng.normal(size=total)
    wide = wide + 0.02 * noise
    if fmt == "cs16":
        wide = wide * 256.0          # use the int16 range like a real SDR
    write_capture(path, wide.astype(np.complex64), fmt)
    return freqs, fc, texts


def synth_real(path: str, fs: int, seconds: float):
    """Airspy-chain real capture: channels mixed relative to F0 = fc +
    fs/4 (air.c:182-185); returns (freqs, fc, texts)."""
    rng = np.random.default_rng(11)
    # fc such that F0 and all channels stay inside the valid 118-138 MHz
    # band (the CLI drops out-of-band frequencies, reference parity)
    fc = 136_000_000 - fs // 4
    f0 = fc + fs // 4
    # four channels on the 25 kHz raster spread across the usable band.
    # The synthetic real model places channel energy at +fo with a
    # conjugate image at -fo, so offsets have pairwise-distinct |fo| (else
    # one channel's image lands ON another) and |fo| large enough that a
    # channel clears its own image
    freqs = [int(round((f0 + off) / 25_000)) * 25_000
             for off in (-1_200_000, -500_000, 250_000, 900_000)]
    total = int(fs * seconds)
    total_bb = int(DEMOD_RATE * seconds)
    real_sig = np.zeros(total, dtype=np.float64)
    texts = []
    ratio = fs / DEMOD_RATE
    for ci, f in enumerate(freqs):
        bb = np.zeros(total_bb, dtype=np.complex128)
        pos = 700 + 1409 * ci
        k = 0
        while pos + 6000 < total_bb:
            text = f"AIR{fs // 1_000_000}C{ci}N{k:02d}"
            content = fg.acars_frame(text=text, label="Q0")
            burst = mod.synthesize_baseband(
                mod.make_burst([content]), start=0, total=None,
                cfo_hz=float(rng.uniform(-400, 400)),
                phase0=float(rng.uniform(0, TWO_PI)),
                timing_frac=float(rng.uniform(0, 1)),
                amplitude=float(10 ** (rng.uniform(-12, 0) / 20)),
            )
            if pos + len(burst) > total_bb:
                break
            bb[pos: pos + len(burst)] += burst
            texts.append(text)
            pos += len(burst) + int(rng.integers(6500, 16000))
            k += 1
        # Re{a(t) e^{j 2 pi fo t}} * 2: channel at fo relative to F0,
        # conjugate image at -fo (outside the per-channel passband)
        n = total
        tt = np.arange(n) / ratio
        i0 = np.clip(np.floor(tt).astype(int), 0, len(bb) - 2)
        frac = tt - i0
        up = bb[i0] * (1 - frac) + bb[i0 + 1] * frac
        fo = f - f0
        real_sig += 2.0 * np.real(
            up * np.exp(1j * TWO_PI * fo / fs * np.arange(n)))
    real_sig = real_sig * 30 + rng.normal(size=total)
    real_sig.astype(np.float32).tofile(path)
    return freqs, fc, texts


def make_capture(spec: str, path: str, seconds: float,
                 channels: int) -> dict:
    """The capture of one format spec (FORMATS) written to path: its CLI
    format, frequencies, fc, synthesized texts and the CLI arguments the
    format needs besides."""
    if spec in REAL_RATES:
        fs = REAL_RATES[spec]
        freqs, fc, texts = synth_real(path, fs, seconds)
        return dict(spec=spec, fmt="f32real", fs=fs, freqs=freqs, fc=fc,
                    texts=texts, cli_args=["--fs", str(fs)])
    if spec not in FORMATS:
        raise ValueError(f"unknown format {spec!r}; one of {FORMATS}")
    freqs, fc, texts = synth_complex(path, spec, 2_000_000, seconds, channels)
    return dict(spec=spec, fmt=spec, fs=2_000_000, freqs=freqs, fc=fc,
                texts=texts, cli_args=[])


def drive(cap: dict, path: str, extra_args=(), device: str = "cuda") -> dict:
    """The port's CLI as a process on one capture (make_capture's record)
    -> the format's result: rc, the texts it decoded and missed, wall
    seconds, the card."""
    cmd = [sys.executable, "-m", "vdlm2dec_tpu_torch.cli",
           *[f"{f / 1e6:.6f}" for f in cap["freqs"]],
           "--iq", path, "--format", cap["fmt"], "--fc", str(cap["fc"]), "-J",
           "--device", device, *cap["cli_args"], *extra_args]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    t0 = time.monotonic()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600,
                       env=env)
    wall = time.monotonic() - t0
    got = set()
    for line in r.stdout.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            j = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "text" in j:
            got.add(j["text"].strip())
    missing = [t for t in cap["texts"] if t not in got]
    return {"fmt": cap["spec"], "fs": cap["fs"], "wall_s": wall,
            "rc": r.returncode, "bursts": len(cap["texts"]),
            "decoded": len(cap["texts"]) - len(missing), "missing": missing,
            "device": device, "card": device_card(device),
            "stderr_tail": r.stderr.strip().splitlines()[-2:]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--formats", default=",".join(FORMATS))
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--channels", type=int, default=8,
                    help="channels of the complex formats (the real ones "
                         "have four)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the CLI's decode (cuda, cpu)")
    ap.add_argument("--cli-args", default="",
                    help="extra CLI args, space-separated (e.g. "
                         "'--max-rows 2' for a short smoke)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cli_extra = tuple(args.cli_args.split())
    results = []
    with tempfile.TemporaryDirectory(prefix="vdl2_formats_") as tmp:
        for spec in args.formats.split(","):
            path = os.path.join(tmp, f"drive_{spec}.bin")
            cap = make_capture(spec, path, args.seconds, args.channels)
            res = drive(cap, path, cli_extra, args.device)
            results.append(res)
            print(json.dumps(res), flush=True)
    bad = [r for r in results if r["missing"] or r["rc"]]
    print(f"# {len(results) - len(bad)}/{len(results)} formats green",
          file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
