"""Configurations, mixes and metric readers are found by name, and a new
file of each kind is taken up through BENCHMARK.json alone."""
import json
import os

import pytest

from vbench import cells, drive


def test_every_entry_has_its_files():
    spec = cells.load_spec()
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        cells.config(spec, w["config"])
        assert cells.traffic(w["traffic"])["mode"] in ("file", "live")
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert callable(cells.reader(m["name"]))


def test_metrics_of_a_cell():
    spec = cells.load_spec()
    e2e = {m["name"] for m in cells.metrics_of(spec, "rtl8-busy-live", "end_to_end")}
    assert e2e == {"frame_latency_p50_ms", "frame_latency_p95_ms", "setup_s"}
    layer = {m["name"] for m in cells.metrics_of(spec, "band760-sparse-file", "per_layer")}
    assert "block_result_wait_ms" not in layer and "k1_roofline_share" in layer


def test_new_files_are_taken_up(tiny_root):
    """A later change adds a mix, a configuration, a metric reader and a
    cell by adding files and entries; no file here changes."""
    bench = tiny_root / "benchmark"
    tr = json.loads((bench / "traffic" / "busy-file.json").read_text())
    tr["gap_min"] = 50000
    (bench / "traffic" / "quiet-file.json").write_text(json.dumps(tr))
    cfg = json.loads((bench / "configs" / "rtl8.json").read_text())
    (bench / "configs" / "rtl1.json").write_text(json.dumps(dict(cfg, channels=1)))
    (bench / "metrics" / "blocks_counted.py").write_text(
        "def read(rec):\n    return float(rec.blocks)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "rtl1", "source": "x", "file": "benchmark/configs/rtl1.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "rtl1-quiet-file", "config": "rtl1",
                              "traffic": "quiet-file", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "blocks_counted", "unit": "blocks", "better": "higher",
                              "source": "host_clock", "layer": "x", "moves": "msps",
                              "workloads": ["rtl1-quiet-file"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    spec = cells.load_spec(str(tiny_root))
    cell = cells.cell(spec, "rtl1-quiet-file")
    assert cells.config(spec, cell["config"], root=str(tiny_root))["channels"] == 1
    assert cells.traffic(cell["traffic"], str(bench))["gap_min"] == 50000
    names = [m["name"] for m in cells.metrics_of(spec, "rtl1-quiet-file", "per_layer")]
    assert names == ["blocks_counted"]

    class Rec:
        blocks = 7
    assert cells.reader("blocks_counted", str(bench))(Rec()) == 7.0


@pytest.mark.parametrize("name", ["rtl8", "band760"])
def test_pipeline_config_of_the_cu8_configurations(name):
    """The PipelineConfig each configuration file stands for, field by field
    (the CLI's flags named in its "cli"): a cu8 capture, real_input off."""
    from vdlm2dec_tpu_torch._tables import PipelineConfig

    spec = cells.load_spec()
    cfg = cells.config(spec, name)
    want = {
        "rtl8": PipelineConfig(
            freqs_hz=[136.6e6 + 50e3 * i for i in range(8)], fs=2_000_000,
            fc_hz=136.5e6, max_symbols=5449, max_candidates=64, max_out=512,
            chan_impl="dft", sync_impl="stream", compute="f32"),
        "band760": PipelineConfig(
            freqs_hz=[118e6 + 25e3 * i for i in range(760)], fs=20_000_000,
            fc_hz=127.5e6, max_symbols=696, max_candidates=16, max_out=1696,
            chan_impl="pfb", sync_impl="stream", compute="f32"),
    }[name]
    assert drive.pipeline_config(cfg) == want
    assert not want.real_input


def test_pipeline_config_of_an_f32real_configuration(tiny_root):
    spec = cells.load_spec(str(tiny_root))
    cfg = cells.config(spec, "airspy2", root=str(tiny_root))
    pc = drive.pipeline_config(cfg)
    assert cfg["format"] == "f32real" and pc.real_input and pc.fs == 5_000_000
