"""The Airspy R2 station (configs/airspy8.json) and the upload layer's
readers (metrics/h2d_ms_per_block.py, metrics/h2d_roofline_share.py): the
configuration as the port runs it, its cell's control flow at a tiny size
on the CPU, the controls that must come out not correct, and the readers'
arithmetic against the port's own count of uploaded bytes."""
import json

import pytest
import torch

from conftest import TINY_CONFIGS
from vbench import cells, drive, gen, harness

torch.set_num_threads(1)
CELL = "airspy8-busy-file"
H2D = ("h2d_ms_per_block", "h2d_roofline_share")


@pytest.fixture
def airspy_root(tiny_root):
    """tiny_root with airspy8.json cut as TINY_CONFIGS cuts rtl8 (two
    channels, 1 s blocks, 1-row bursts), its fc chosen again for the cut
    plan as the full one was (io.sdr.choose_fc_airspy)."""
    from vdlm2dec_tpu_torch.io.sdr import choose_fc_airspy

    path = tiny_root / "benchmark" / "configs" / "airspy8.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY_CONFIGS["rtl8"])
    cfg["fc_hz"] = choose_fc_airspy(gen.channel_plan(cfg), cfg["fs"])
    path.write_text(json.dumps(cfg))
    return tiny_root


def _run(root, seconds=2.0, trace=False, control=None, seed=2**31 + 11):
    spec = cells.load_spec(str(root))
    return harness.run_cell(spec, cells.cell(spec, CELL), seed, seconds, trace,
                            device="cpu", control=control,
                            bench_dir=str(root / "benchmark"))


def test_pipeline_config_of_airspy8():
    """The PipelineConfig the configuration file stands for, field by field:
    real input at 5 Msps, fc as the CLI's choose_fc_airspy picks it for
    rtl8's plan, the dft residue tables unsplit (p_in 5000)."""
    from vdlm2dec_tpu_torch._tables import PipelineConfig
    from vdlm2dec_tpu_torch.io.sdr import choose_fc_airspy
    from vdlm2dec_tpu_torch.pipeline import Pipeline

    spec = cells.load_spec()
    cfg = cells.config(spec, "airspy8")
    plan = [136_600_000 + 50_000 * i for i in range(8)]
    assert gen.channel_plan(cfg) == plan
    assert cfg["fc_hz"] == choose_fc_airspy(plan, 5_000_000) == 137_250_000
    want = PipelineConfig(
        freqs_hz=[float(f) for f in plan], fs=5_000_000, fc_hz=137.25e6,
        real_input=True, max_symbols=5449, max_candidates=64, max_out=512,
        chan_impl="dft", sync_impl="stream", compute="f32")
    assert drive.pipeline_config(cfg) == want
    assert cells.config(spec, "rtl8")["guarantees"] == cfg["guarantees"]
    assert "--format f32real --fs 5000000 --fc 137250000" in cfg["cli"]
    ch = Pipeline(want, "cpu").channelizer
    assert (ch.impl, ch.p_in, ch.p_out) == ("dft", 5000, 84)


def test_airspy8_cell_runs_correct(airspy_root):
    r = _run(airspy_root)
    assert r["correct"], r["info"]["tally"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"msps", "setup_s"}
    gap = r["checks"]["sync_df_gap_hz"]
    assert gap["value"] <= gap["limit"]


@pytest.mark.parametrize("control,check", [("bf16", "sync_df_gap_hz"),
                                           ("no_margin", "missed_wrong_extra")])
def test_airspy8_controls_come_out_not_correct(airspy_root, control, check):
    """The program's own bfloat16 path fails the soft comparison; a block's
    right margin left out loses the bursts that straddle its end."""
    r = _run(airspy_root, seconds=3.0 if control == "no_margin" else 2.0,
             control=control)
    assert not r["correct"]
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def test_airspy8_traced_run_reports_the_upload_metrics_or_none(airspy_root):
    """Every per-layer metric of the cell is read; the CPU's trace has no
    host-to-device copy, so the device-trace readers, the two new ones
    among them, return nothing and the line leaves them out."""
    r = _run(airspy_root, trace=True)
    spec = cells.load_spec(str(airspy_root))
    listed = {m["name"] for m in cells.metrics_of(spec, CELL, "per_layer")}
    assert set(H2D) <= listed
    assert set(r["metrics"]) == {"decode_slot_yield", "host_output_ms_per_block"}
    assert r["device"]["window_s"] > 0


class _Rec:
    """The fields of drive.Record that the upload readers take."""

    def __init__(self, cfg, k1_shape, trace, trace_blocks):
        self.config, self.k1_shape = cfg, k1_shape
        self.trace, self.trace_blocks = trace, trace_blocks


@pytest.mark.parametrize("name", ["rtl8", "band760", "airspy8"])
def test_reader_block_bytes_are_the_port_count(airspy_root, name):
    """The reader's raw bytes a block equal PipelineMetrics.h2d_bytes over
    the blocks the file route uploaded, in each configuration's format and
    channelizer (cu8 dft, cu8 pfb, f32real dft)."""
    from vdlm2dec_tpu_torch import pipeline as pl
    from vdlm2dec_tpu_torch.metrics import PipelineMetrics

    bench = airspy_root / "benchmark"
    spec = cells.load_spec(str(airspy_root))
    cfg = cells.config(spec, name, root=str(airspy_root))
    tr = dict(cells.traffic("busy-file", str(bench)), seconds=2.5)
    cap = gen.make_capture(cfg, tr, 2**31 + 5, "cpu")
    pipe = pl.Pipeline(drive.pipeline_config(cfg), "cpu")
    pipe.metrics = PipelineMetrics()
    block_s = float(cfg["block_seconds"])
    n = sum(1 for _ in pipe.stream_wideband_u8(cap.raw, block_seconds=block_s,
                                               fmt=cap.fmt))
    assert n >= 2 and pipe.metrics.h2d_bytes % n == 0
    # a trace of n blocks whose uploads took 1 ms each
    trace = {"kernels": {"Memcpy HtoD (Pageable -> Device)": (n, n * 1e-3)}}
    rec = _Rec(cfg, drive.k1_shape(pipe, block_s), trace, n)
    share = cells.reader("h2d_roofline_share", str(bench))(rec)
    assert share == pytest.approx(100 * pipe.metrics.h2d_bytes / n / 64e9 / 1e-3, rel=1e-12)


def test_upload_readers_on_a_device_trace(airspy_root):
    """On a trace with host-to-device copies: h2d_ms_per_block sums them
    (and nothing else) over the traced blocks, h2d_roofline_share is the
    block's bytes at 64 GB/s over that mean, and both are None without a
    copy, a traced block or a K1 shape."""
    bench = str(airspy_root / "benchmark")
    ms = cells.reader("h2d_ms_per_block", bench)
    share = cells.reader("h2d_roofline_share", bench)
    cfg = cells.config(cells.load_spec(str(airspy_root)), "airspy8",
                       root=str(airspy_root))
    kernels = {"Memcpy HtoD (Pageable -> Device)": (10, 0.160),
               "Memcpy HtoD (Pinned -> Device)": (10, 0.002),
               "Memcpy DtoH (Device -> Pinned)": (10, 0.5),
               "sync_scan_kernel": (10, 0.3)}
    rec = _Rec(cfg, (2, 84_000), {"kernels": kernels}, 10)
    assert ms(rec) == pytest.approx(16.2)
    raw_bytes = 84_000 * cfg["fs"] // 84_000 * 4
    assert share(rec) == pytest.approx(100 * raw_bytes / 64e9 / 0.0162)
    assert 0 < share(rec) < 100
    assert ms(_Rec(cfg, (2, 84_000), {"kernels": {"k": (1, 1.0)}}, 10)) is None
    assert share(_Rec(cfg, (2, 84_000), {"kernels": {"k": (1, 1.0)}}, 10)) is None
    assert ms(_Rec(cfg, (2, 84_000), {"kernels": kernels}, 0)) is None
    assert share(_Rec(cfg, None, {"kernels": kernels}, 10)) is None
    assert ms(_Rec(cfg, (2, 84_000), None, 10)) is None
