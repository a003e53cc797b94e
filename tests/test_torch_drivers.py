"""The port's drivers against the JAX package's tools, on the CPU.

drive_formats, soak_compare and scaling_bench of vdlm2dec_tpu_torch are
the twins of tools/drive_formats.py, tools/soak_compare.py and
tools/scaling_bench.py.  Their synthesizers give the tools' arrays bit for
bit on the same seed; each driver runs green at a small size on the CPU;
the soak's frames equal those of the JAX Pipeline + FrameDecoder run that
tools/soak_compare.py makes on the same capture; the scaling bench writes
nowhere but where it is told.
"""
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from tools import drive_formats as jdrive
from tools import soak_compare as jsoak
from vdlm2dec_tpu.host.decoder import FrameDecoder as JFrameDecoder
from vdlm2dec_tpu.host.output import OutputConfig as JOutputConfig
from vdlm2dec_tpu.pipeline import Pipeline as JPipeline
from vdlm2dec_tpu.pipeline import PipelineConfig as JPipelineConfig
from vdlm2dec_tpu_torch import drive_formats, scaling_bench, soak_compare
from vdlm2dec_tpu_torch.pipeline import Pipeline

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drive_complex(port, tmp):
    out = []
    for fmt in ("cu8", "cs16", "cf32"):
        path = os.path.join(tmp, f"{port.__name__}.{fmt}")
        meta = port.synth_complex(path, fmt, 2_000_000, 1.0, 2)
        with open(path, "rb") as fh:
            out.append((meta, fh.read()))
    return out


def _drive_real(port, tmp):
    path = os.path.join(tmp, f"{port.__name__}.f32")
    meta = port.synth_real(path, 5_000_000, 1.0)
    with open(path, "rb") as fh:
        return meta, fh.read()


def _soak_complex(port, _tmp):
    freqs = [136_600_000 + 50_000 * i for i in range(2)]
    truth = []
    kw = dict(truth=truth) if port is soak_compare else {}
    wide, n_tx = port.synth("cfo", 2_000_000, 136_775_000, freqs, 1,
                            np.random.default_rng(42), impair_ppm=2.0,
                            spread_db=12.0, **kw)
    if port is soak_compare:
        assert len(truth) == n_tx and truth[0]["text"] == "SOAK 0 1000"
    return wide, n_tx


def _soak_real(port, _tmp):
    fs = 5_000_000
    f0 = 136_000_000
    freqs = [f0 - 1_200_000, f0 + 250_000]
    kw = dict(truth=[]) if port is soak_compare else {}
    return port.synth_real(fs, f0, freqs, 1, np.random.default_rng(42),
                           impair_ppm=2.0, spread_db=12.0, **kw)


@pytest.mark.parametrize("synth", [_drive_complex, _drive_real,
                                   _soak_complex, _soak_real])
def test_synthesizers_equal_the_tools(synth, tmp_path):
    """The same seed gives the same capture, bit for bit, and the same
    plan: drive_formats' complex formats and airspy chain, the soak's
    impaired complex traffic (its truth records cost no rng draw) and its
    airspy chain."""
    pairs = {"drive": (drive_formats, jdrive), "soak": (soak_compare, jsoak)}
    port, jax_tool = pairs[synth.__name__.split("_")[1]]
    got = synth(port, str(tmp_path))
    want = synth(jax_tool, str(tmp_path))
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        if isinstance(g[0], np.ndarray):
            assert np.array_equal(g[0], w[0]) and g[1] == w[1] > 0
        else:
            assert g == w and len(g[1]) > 0


def test_drive_formats_green_on_the_cpu(capsys):
    """Two formats through the port's CLI as processes: every text back,
    rc 0, one JSON line a format."""
    rc = drive_formats.main(["--device", "cpu", "--formats", "cu8,f32real5",
                             "--seconds", "2", "--channels", "2",
                             "--cli-args", "--max-rows 2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [r["fmt"] for r in lines] == ["cu8", "f32real5"]
    for r in lines:
        assert r["rc"] == 0 and r["missing"] == [] and r["card"] == "cpu"
        assert r["decoded"] == r["bursts"] > 0
    with pytest.raises(ValueError, match="unknown format"):
        drive_formats.make_capture("cu4", os.devnull, 1.0, 1)


def _jax_soak_keys(cap, path):
    """tools/soak_compare.py's own side (its lines 208-237) on the
    capture: the JAX Pipeline and FrameDecoder, matmul, sync "xla"."""
    cfg = JPipelineConfig(
        freqs_hz=[float(f) for f in cap["freqs"]], fs=cap["fs"],
        fc_hz=float(cap["fc"]), real_input=False, max_symbols=1024,
        max_candidates=64, chan_impl="matmul", sync_impl="xla",
        compute="f32", max_out=max(96, 56 * len(cap["freqs"])))
    buf = io.StringIO()
    dec = JFrameDecoder(JOutputConfig(verbose=0, jsonout=True, logfile=buf))
    for bursts in JPipeline(cfg).stream_wideband_u8(
            np.fromfile(path, dtype=np.uint8), block_seconds=4.0):
        for b in bursts:
            dec.process_burst(b)
    return sorted(soak_compare.record_key(json.loads(ln))
                  for ln in buf.getvalue().splitlines() if ln.strip())


def test_soak_clean_matches_truth_and_the_jax_tool(tmp_path, monkeypatch,
                                                   capsys):
    """clean at 2 s on the CPU: every transmitted burst back and nothing
    else, the JAX tool's frame keys on the same capture, and without the
    compiled reference "reference": null and exit 0."""
    path = str(tmp_path / "soak.cu8")
    truth = []
    cap = soak_compare.make_capture("clean", path, 2, truth=truth)
    pipe = Pipeline(soak_compare.pipeline_config(cap), device="cpu")
    ours = sorted(map(soak_compare.record_key,
                      soak_compare.decode(pipe, path, False)))
    assert ours == sorted(soak_compare.truth_keys(truth).elements())
    assert len(ours) == cap["tx"] > 0
    assert ours == _jax_soak_keys(cap, path)

    monkeypatch.setattr(soak_compare, "REF_SHIM",
                        str(tmp_path / "no_ref_shim"))
    out = tmp_path / "soak.json"
    assert soak_compare.main(["--seconds", "2", "--device", "cpu",
                              "--json", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary["reference"] is None
    assert summary["recall"] == f"{cap['tx']}/{cap['tx']}"
    assert summary["extra"] == summary["candidates_overflow"] == 0
    assert "reference: not built" in capsys.readouterr().out


def test_soak_raises_on_slot_overflow(tmp_path):
    """A dropped sync candidate is an error with its count, not a quiet
    loss."""
    path = str(tmp_path / "soak.cu8")
    cap = soak_compare.make_capture("clean", path, 2)
    cfg = soak_compare.pipeline_config(cap)
    cfg.max_out = 4
    with pytest.raises(RuntimeError, match="sync candidates dropped"):
        soak_compare.decode(Pipeline(cfg, device="cpu"), path, False)


def test_scaling_bench_on_gloo_workers_writes_only_its_out(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """P = 1 and 2 over a 2 s capture on CPU workers: the same frame set,
    the truth, and nothing written but --out (the capture and the
    stimulus cache go to the temporary directory, here tmp_path);
    SCALING_MEASURED.json, the JAX package's record, is untouched."""
    record = os.path.join(REPO, "SCALING_MEASURED.json")
    with open(record, "rb") as fh:
        before = fh.read()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    out = tmp_path / "scaling.json"
    rc = scaling_bench.main(["--device", "cpu", "--processes", "1,2",
                             "--repeats", "1", "--seconds", "2",
                             "--out", str(out)])
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and res == json.loads(out.read_text())
    assert res["frames_identical_across_runs"]
    n, of = res["recall"].split("/")
    assert n == of and int(of) > 0 and res["frames_beyond_truth"] == 0
    assert [r["processes"] for r in res["runs"]] == [1, 2]
    two = res["runs"][1]
    assert two["backend"] == "gloo" and two["devices"] == ["cpu", "cpu"]
    assert not two["shared_card"] and "efficiency_paired" in two
    assert os.listdir(work) == []
    assert {p.name for p in tmp_path.iterdir()
            if not p.name.endswith(".npz")} == {"cwd", "scaling.json"}
    with open(record, "rb") as fh:
        assert fh.read() == before


def test_scaling_bench_lays_workers_on_cards():
    """Worker p takes cards p k .. p k + k - 1; more workers than cards
    share them, which is marked; the default P steps up to the cards."""
    assert scaling_bench.worker_devices(2, 2, "cuda", 4) == (
        ["cuda:0,cuda:1", "cuda:2,cuda:3"], False)
    assert scaling_bench.worker_devices(2, 1, "cuda", 1) == (
        ["cuda:0", "cuda:0"], True)
    assert scaling_bench.worker_devices(2, 1, "cpu", 0) == (
        ["cpu", "cpu"], False)
    assert scaling_bench.default_processes(4, 1) == [1, 2, 4]
    assert scaling_bench.default_processes(6, 1) == [1, 2, 4, 6]
    assert scaling_bench.default_processes(4, 2) == [1, 2]
    assert scaling_bench.default_processes(1, 1) == [1]
