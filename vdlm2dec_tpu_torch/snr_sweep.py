"""SNR sweep: frame decode probability against SNR, 2-20 dB.

    python3 -m vdlm2dec_tpu_torch.snr_sweep [--trials 20] [--snrs 2 4 ... 20]
                                           [--golden] [--payload 40]
                                           [--device cuda]

Synthesizes one burst a trial at a controlled SNR, with a random timing
phase and carrier offset, decodes it through Pipeline.decode_channels on
--device and prints one JSON line per SNR point with the share of trials
whose frame came back (`port_rate`); --golden adds the scalar model's
share on the same signals (`golden_rate`, golden/dsp.GoldenChannel, on
the host).  The twin of tools/snr_sweep.py of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import modulator as mod
from ._tables import PipelineConfig
from .golden.codec import deframe_block
from .golden.dsp import GoldenChannel
from .pipeline import Pipeline


def sweep(snrs, trials: int, payload: int, golden: bool, device,
          seed: int = 0):
    """Yield one row per SNR point: {"snr_db", "port_rate"[,
    "golden_rate"]}."""
    cfg = PipelineConfig(freqs_hz=[136_975_000.0], fc_hz=136_900_000.0,
                         max_symbols=1024, max_candidates=8)
    pipe = Pipeline(cfg, device=device)
    rng = np.random.default_rng(seed)
    for snr in snrs:
        ok_p = ok_g = 0
        for _trial in range(trials):
            content = rng.integers(0, 256, payload).astype(np.uint8)
            plan = mod.make_burst([content])
            sig = mod.synthesize_baseband(
                plan, start=400, total=3000,
                timing_frac=float(rng.random()),
                cfo_hz=float(rng.normal(0, 100)),
            )
            sig = mod.awgn(sig, snr, rng)
            bursts = pipe.decode_channels(sig[None, :].astype(np.complex64))
            if any(np.array_equal(f[1:-3], content)
                   for b in bursts for f in b.frames):
                ok_p += 1
            if golden:
                for b in GoldenChannel().run(sig):
                    fr, _ = deframe_block(b.block, b.nbrow, b.nlbyte)
                    if any(np.array_equal(f[1:-3], content) for f in fr):
                        ok_g += 1
                        break
        row = {"snr_db": snr, "port_rate": round(ok_p / trials, 3)}
        if golden:
            row["golden_rate"] = round(ok_g / trials, 3)
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--snrs", type=float, nargs="*",
                    default=[2, 3, 4, 5, 6, 8, 10, 14, 20])
    ap.add_argument("--golden", action="store_true",
                    help="also run the scalar model")
    ap.add_argument("--payload", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decode (default cuda)")
    args = ap.parse_args(argv)
    for row in sweep(args.snrs, args.trials, args.payload, args.golden,
                     args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
