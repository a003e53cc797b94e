"""One tiny CPU run of each cell's control flow through the port, the
result line it prints, the control and the planted faults that must come
out not correct."""
import json
import sys

import numpy as np
import pytest
import torch

from vbench import cells, harness

torch.set_num_threads(1)
CELLS = ["rtl8-busy-file", "band760-sparse-file", "rtl8-busy-live"]
# the f32real stand-in's cells (conftest.STANDINS): the real-input route
STANDIN_CELLS = ["airspy2-busy-file", "airspy2-busy-live"]


def _run(root, cell_name, seconds=3.0, trace=False, control=None, seed=2**31 + 7):
    spec = cells.load_spec(str(root))
    cell = cells.cell(spec, cell_name)
    return harness.run_cell(spec, cell, seed, seconds, trace, device="cpu",
                            control=control, bench_dir=str(root / "benchmark"))


@pytest.mark.parametrize("cell_name", CELLS + STANDIN_CELLS)
def test_cell_runs_correct(tiny_root, cell_name):
    r = _run(tiny_root, cell_name, seconds=4.0 if "live" in cell_name else 2.0)
    assert r["correct"], r["info"]["tally"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["missed_wrong_extra"]["value"] == 0
    names = set(r["metrics"])
    if "live" in cell_name:
        assert names == {"frame_latency_p50_ms", "frame_latency_p95_ms", "setup_s"}
        assert r["info"]["feed"]["writes"] > 0
    else:
        assert names == {"msps", "setup_s"}
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"
    assert r["checks"]["sync_df_gap_hz"]["value"] <= r["checks"]["sync_df_gap_hz"]["limit"]
    sixths = r["info"]["sixths"]
    assert sum(sixths["blocks"]) == r["info"]["blocks"] or "live" in cell_name


def test_traced_run_reports_per_layer_metrics(tiny_root):
    r = _run(tiny_root, "rtl8-busy-file", seconds=2.0, trace=True)
    # the CPU has no device trace: the device readers return nothing
    assert set(r["metrics"]) == {"decode_slot_yield", "host_output_ms_per_block"}
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_result_line_and_checks_last(tiny_root, capsys):
    r = _run(tiny_root, "rtl8-busy-file", seconds=1.0)
    harness.emit(r)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for k, v in line["checks"].items():
        assert set(v) == {"value", "limit"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


@pytest.mark.parametrize("cell_name", CELLS + STANDIN_CELLS)
def test_control_comes_out_not_correct(tiny_root, cell_name):
    """The control: the program's own bfloat16 path, one precision below
    the float32 the configurations state.  It prints every message right
    and fails the soft comparison."""
    r = _run(tiny_root, cell_name, seconds=4.0 if "live" in cell_name else 2.0,
             control="bf16")
    assert not r["correct"]
    gap = r["checks"]["sync_df_gap_hz"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("cell_name", CELLS + STANDIN_CELLS)
def test_no_margin_comes_out_not_correct(tiny_root, cell_name):
    """A planted fault: each block's right margin left out."""
    r = _run(tiny_root, cell_name, seconds=4.0 if "live" in cell_name else 3.0,
             control="no_margin")
    assert not r["correct"]
    assert r["checks"]["missed_wrong_extra"]["value"] > 0


def _fault_stale(monkeypatch):
    """A step that returns its state unchanged: every block's result is
    the first block's."""
    from vdlm2dec_tpu_torch import pipeline as pl

    first = {}
    real = pl.unpack_results

    def stale(buf):
        return first.setdefault("r", real(buf))
    monkeypatch.setattr(pl, "unpack_results", stale)


def _fault_half(monkeypatch):
    """Half of each block's candidates left out."""
    from vdlm2dec_tpu_torch import pipeline as pl

    real = pl.Pipeline._finish

    def half(self, cands, t_offset, prev_end=None):
        return real(self, cands[::2], t_offset, prev_end)
    monkeypatch.setattr(pl.Pipeline, "_finish", half)


def _fault_altered(monkeypatch):
    """An answer altered where it is produced: one byte of every deframed
    frame's body flipped."""
    from vdlm2dec_tpu_torch import pipeline as pl

    real = pl.deframe_corrected

    def altered(block, nbrow, nlbyte):
        out = []
        for f in real(block, nbrow, nlbyte):
            f = np.array(f, copy=True)
            f[len(f) // 2] ^= 0x01
            out.append(f)
        return out
    monkeypatch.setattr(pl, "deframe_corrected", altered)


@pytest.mark.parametrize("fault", [_fault_stale, _fault_half, _fault_altered])
@pytest.mark.parametrize("cell_name", ["rtl8-busy-file", "rtl8-busy-live"])
def test_fault_comes_out_not_correct(tiny_root, monkeypatch, fault, cell_name):
    fault(monkeypatch)
    r = _run(tiny_root, cell_name, seconds=4.0 if "live" in cell_name else 2.0)
    assert not r["correct"]


@pytest.mark.cuda
def test_cell_on_the_card(cuda_card):
    """A short run of the first cell on the card, as the benchmark runs it."""
    import subprocess

    from conftest import ROOT

    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "rtl8-busy-file",
                          "--seed", "12345", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
