"""The port's bench program on the CPU: the legs' control flow, the recall
gate against the JAX package's bench on one seed, the latency harness and
the compact last line.  The times and rates it prints here are the CPU's;
the measurements are taken on a card."""
import json

import numpy as np
import pytest
import torch

import bench as jax_bench
from vdlm2dec_tpu_torch import bench, stimulus

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

GATE_KEYS = ("recall", "frames", "bursts", "duplicates", "leakage",
             "spurious", "edge")


@pytest.fixture(scope="module")
def small_leg():
    """run_config on a 2-channel 0.25 s capture, on the CPU."""
    return bench.run_config(2, 0.25, 1, 512, None, False, device="cpu",
                            chan_impl="auto", sync_impl="stream")


def test_run_config_full_recall_no_overflow_three_passes(small_leg):
    out = small_leg
    n, of = out["recall"].split("/")
    assert n == of and int(of) >= 2 and out["bursts"] == int(of)
    assert out["candidates_overflow"] == 0
    assert len(out["msps_passes"]) == bench.PASSES >= 3
    assert min(out["msps_passes"]) <= out["msps"] <= max(out["msps_passes"])
    assert out["device"] == "cpu" and out["card"] == "cpu"
    assert out["chan_impl"] == "dft"
    assert "peak_mem_mb" not in out          # a device figure: cards only


def test_run_config_gate_equals_the_jax_bench(small_leg):
    """One seed through both bench programs: the same recall, frames,
    duplicates, leakage, spurious and edge."""
    theirs = jax_bench.run_config(2, 0.25, 1, 512, None, False,
                                  chan_impl="auto", sync_impl="stream")
    assert {k: small_leg[k] for k in GATE_KEYS} == \
        {k: theirs[k] for k in GATE_KEYS}


def test_run_config_streams_in_blocks():
    out = bench.run_config(2, 0.5, 1, 512, None, False, device="cpu",
                           chan_impl="pfb", sync_impl="stream",
                           block_seconds=0.25)
    assert out["block_seconds"] == 0.25 and out["chan_impl"] == "pfb"
    n, of = out["recall"].split("/")
    assert n == of and out["candidates_overflow"] == 0
    assert out["duplicates"] == out["leakage"] == out["spurious"] == 0


def test_recall_gate_raises_on_a_missing_burst(monkeypatch):
    """A burst in the truth that the decode does not return fails the
    leg."""
    make = stimulus.make_capture

    def with_a_ghost(*a, **kw):
        wide, freqs, fc, truth = make(*a, **kw)
        return wide, freqs, fc, truth + [(1, b"never transmitted", 700, 900)]

    monkeypatch.setattr(stimulus, "make_capture", with_a_ghost)
    with pytest.raises(RuntimeError, match="recall failure: 1/"):
        bench.run_config(2, 0.25, 1, 512, None, False, device="cpu",
                         chan_impl="auto")


def test_run_leg_on_a_prepared_capture(small_leg):
    """leg_pipeline + run_leg is run_config: a caller that needs the
    leg's pipeline and bytes for something else builds them once."""
    pipe, raw, truth = bench.leg_pipeline(2, 0.25, 512, None, False, "cpu",
                                          chan_impl="auto")
    wide, _f, _fc, want_truth = stimulus.make_capture(2_000_000, 2, 0.25)
    np.testing.assert_array_equal(raw, stimulus.to_u8(wide))
    assert truth == want_truth
    # 22 slots a second of an active channel and JUNK_SLOTS a channel-second
    assert pipe.cfg.max_out == max(64, 11 + int(bench.JUNK_SLOTS * 0.25 * 2))
    out = bench.run_leg(pipe, raw, truth, 1)
    assert {k: out[k] for k in GATE_KEYS} == {k: small_leg[k] for k in GATE_KEYS}
    assert out["block_samples"] == small_leg["block_samples"] == len(raw) // 2


def test_leg_raises_when_decode_slots_overflow():
    """Fewer slots than candidates: the counter is not 0 and the leg
    raises (the truth is emptied so that the recall gate stays silent)."""
    import dataclasses

    pipe, raw, _truth = bench.leg_pipeline(2, 0.25, 512, None, False, "cpu",
                                           chan_impl="auto")
    few = bench.Pipeline(dataclasses.replace(pipe.cfg, max_out=2),
                         device="cpu")
    with pytest.raises(RuntimeError, match="sync candidates dropped"):
        bench.run_leg(few, raw, [], 1)


def test_2000_channel_plan_has_a_burst_on_both_edges():
    """The plan only (no synthesis, no decode): active_every=100 ends at
    channel 1900, so the leg names channel C-1 besides."""
    plan = bench.KCHAN_LEG
    active = stimulus.active_channels(plan["channels"], plan["active_every"],
                                      plan["also_active"])
    assert plan["channels"] == 2000
    assert active[0] == 0 and active[-1] == 1999 and len(active) == 21
    assert stimulus.active_channels(2000, 100)[-1] == 1900
    # the named channel gets bursts and truth, at a small size
    _w, _f, _fc, truth = stimulus.make_capture(2_000_000, 6, 0.1, spacing=25_000,
                                               active_every=4,
                                               also_active=(5,))
    assert {c for c, *_ in truth} == {0, 4, 5}


def test_device_legs_need_a_card():
    with pytest.raises(ValueError, match="CUDA events"):
        bench.run_device_config(2, 0.25, 3, 1, 512, None, False,
                                device="cpu", chan_impl="auto")


def test_packed_checksum_skips_the_float_words():
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 256, (5, 2096)).astype(np.uint8)
    want = int(packed[:, :2076].sum() + packed[:, 2084:].sum())
    assert bench.packed_checksum(packed) == want
    other = packed.copy()
    other[:, 2076:2084] ^= 0xFF                  # of / df words
    assert bench.packed_checksum(other) == want
    other[2, 100] ^= 1
    assert bench.packed_checksum(other) != want


def test_run_latency_smoke():
    out = bench.run_latency(0.25, seconds=2.0, channels=2, device="cpu")
    assert "error" not in out
    assert out["blocks"] >= 3
    assert out["p50_ms"] > 0
    assert out["p95_ms"] >= out["p50_ms"]
    assert out["max_ms"] >= out["p95_ms"]
    # percentile helper stays inside bounds on tiny samples
    assert out["max_ms"] < 60_000
    # paced real-time submission + backlog evidence
    assert out["paced_realtime"] is True
    assert out["max_backlog_blocks"] >= 1
    assert isinstance(out["sustained"], bool)
    assert out["lag_last_quarter_ms"] >= 0.0
    # no entry from before the rebase survives: of the 8 blocks, those
    # submitted before the first completion are warm-up
    assert out["warmup_blocks"] >= 1
    assert out["blocks"] == 8 - out["warmup_blocks"]
    assert isinstance(out["stalls"], int) and out["stalls"] >= 0
    assert "h2d_block_ms" not in out             # a device figure: cards only


def test_latency_capture_too_short():
    out = bench.run_latency(1.0, seconds=1.0, channels=2, device="cpu")
    assert out == {"error": "capture too short for latency mode"}


def _main(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)                  # bench_full.json lands here
    rc = bench.main(argv)
    out = capsys.readouterr().out.splitlines()
    return rc, out


def test_main_quick_prints_one_compact_line(tmp_path, monkeypatch, capsys):
    rc, out = _main(["--quick", "--device", "cpu", "--no-device",
                     "--channels", "2"], tmp_path, monkeypatch, capsys)
    assert rc == 0
    assert len(out) == 1 and len(out[0]) < 1500
    line = json.loads(out[0])
    assert line["metric"] == "wideband_iq_decode_throughput"
    assert line["value"] > 0 and line["card"] == "cpu"
    assert line["failed"] == []
    primary = line["extra"]["summary"]["primary"]
    assert len(primary["msps_passes"]) >= 3
    n, of = primary["recall"].split("/")
    assert n == of
    full = json.loads((tmp_path / "bench_full.json").read_text())
    assert full["primary"]["candidates_overflow"] == 0
    assert "device_8ch" not in full["extra"]


def test_main_exits_nonzero_when_a_leg_fails(tmp_path, monkeypatch, capsys):
    def broken(*a, **kw):
        raise RuntimeError("leg made to fail")

    monkeypatch.setattr(bench, "run_latency", broken)
    rc, out = _main(["--quick", "--device", "cpu", "--no-device",
                     "--channels", "2", "--latency"], tmp_path, monkeypatch,
                    capsys)
    assert rc == 1
    line = json.loads(out[-1])
    assert line["failed"] == ["latency"] and line["value"] > 0
    assert "leg made to fail" in line["extra"]["summary"]["lat"]["error"]


def test_main_refuses_device_legs_off_the_card(tmp_path, monkeypatch, capsys):
    rc, out = _main(["--quick", "--device", "cpu"], tmp_path, monkeypatch,
                    capsys)
    assert rc == 2 and out == []
