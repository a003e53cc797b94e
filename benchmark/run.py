"""The benchmark of the PyTorch/CUDA port (vdlm2dec_tpu_torch): one run of
one cell.

    python3 benchmark/run.py --workload rtl8-busy-file --seed 7 --seconds 30 --trace 0

Runs the cell named in BENCHMARK.json once on the first CUDA card and
prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks`, every number compared beside its limit (also the last
lines of standard error).  Exits non-zero, printing no result, without a
card, when the run's checkout lacks the port, or when JAX or the JAX
package got loaded.

--control bf16 runs the control in place of the program as the
configuration states it: the program's own bfloat16 path, one precision
below the float32 the configurations state.  --control no_margin plants a
fault: each block's right margin left out.  The benchmark's own runs pass
neither.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches of the program stay inside the checkout, at
# fixed paths (the port builds its own kernels into vdlm2dec_tpu_torch/_build)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

BANNED = ("jax", "jaxlib", "flax", "vdlm2dec_tpu", "bench", "tools")
CONTROLS = ("bf16", "no_margin")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (vdlm2dec_tpu_torch is not vdlm2dec_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=CONTROLS, default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from vbench import cells

    try:
        spec = cells.load_spec(ROOT)
        cell = cells.cell(spec, args.workload)
        cells.config(spec, cell["config"], root=ROOT)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    # the program's host work is Python, numpy and its dispatch and fetch
    # threads: PyTorch's CPU pool only spins against them
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import vdlm2dec_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the port is not in this checkout: {e}", file=sys.stderr)
        return 2
    from vbench import harness

    result = harness.run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START, control=args.control)
    bad = banned_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
