"""The latency, rate, roofline and trace arithmetic on hand-made records."""
import json
import os
import statistics

import numpy as np
import pytest

from vbench import cells, drive, gen, protocol, reference, roofline, trace


def _rec(**kw):
    rec = drive.Record(cell={}, config={"sync_impl": "stream"}, traffic={"mode": "file"})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def _read(name, rec):
    return cells.reader(name)(rec)


def test_rate_is_all_samples_over_the_window():
    rec = _rec(samples=8_000_000 * 90, window_s=30.0)
    assert _read("msps", rec) == pytest.approx(24.0)
    assert _read("msps", _rec(samples=0, window_s=0.0)) is None
    live = _rec(samples=1, window_s=30.0)
    live.traffic = {"mode": "live"}
    assert _read("msps", live) is None


def test_latency_quantiles():
    lat = [float(v) for v in range(1, 101)]
    rec = _rec(latencies_ms=lat)
    assert _read("frame_latency_p50_ms", rec) == pytest.approx(statistics.quantiles(lat, n=100)[49])
    assert _read("frame_latency_p95_ms", rec) == pytest.approx(statistics.quantiles(lat, n=100)[94])
    assert _read("frame_latency_p95_ms", _rec()) is None
    assert _read("block_result_wait_ms", _rec(block_waits_ms=[4100.0, 8000.0, 8100.0])) == pytest.approx(6733.3333, abs=1e-3)


def test_live_latency_counts_a_missing_burst_at_its_age():
    class Judge:
        def locate(self, line):
            return (int(line), 0, True)
    sink = drive.LineSink()
    sink.texts, sink.times = ["0\n"], drive.array("d", [12.0])
    sink.streams = drive.array("i", [1])
    rec = _rec(due_t={(0, 0): 10.0, (1, 0): 11.0}, t_close=20.0)
    assert sorted(drive.live_latencies(Judge(), sink, rec)) == [2000.0, 9000.0]


def test_k1_roofline_share():
    c, t = 8, 380_000
    bound = roofline.k1_bound_s(c, t, "stream")
    # operations bound it: 353 per position over 67 TFLOP/s
    assert bound == pytest.approx(c * t * 353 / 67e12)
    tr = {"kernels": {"void (anonymous namespace)::sync_scan_kernel<0>(...)": (4, 4 * 3 * bound),
                      "other": (10, 1.0)}}
    rec = _rec(trace=tr, k1_shape=(c, t))
    assert _read("k1_roofline_share", rec) == pytest.approx(100.0 / 3)
    assert _read("k1_roofline_share", _rec(trace={"kernels": {"x": (1, 1.0)}}, k1_shape=(c, t))) is None


def test_trace_reduction_busy_and_gaps():
    us = 1e6
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 0.1 * us},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 0.05 * us, "dur": 0.1 * us},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 0.5 * us, "dur": 0.1 * us},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.7 * us, "dur": 0.1 * us},
        {"ph": "X", "cat": "user_annotation", "name": "stream.next", "ts": 0.1 * us, "dur": 0.45 * us},
        {"ph": "X", "cat": "user_annotation", "name": "output", "ts": 0.6 * us, "dur": 0.12 * us},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 5.0},
    ]
    s = trace.reduce(events, 1.0)
    assert s["busy_s"] == pytest.approx(0.15 + 0.1 + 0.1)
    assert s["window_s"] == 1.0
    assert s["kernels"]["a"] == (2, pytest.approx(0.2))
    assert [g[0] for g in s["idle_gaps"]] == ["stream.next", "output"]
    assert s["idle_gaps"][0][1] == pytest.approx(0.35)
    assert s["device_ops"][0] == ["a", pytest.approx(0.2)]


def test_device_readers():
    tr = {"busy_s": 0.5, "window_s": 2.0, "kernels": {"a": (3, 0.3), "b": (1, 0.1)}}
    assert _read("device_idle_share", _rec(trace=tr)) == pytest.approx(75.0)
    assert _read("device_ms_per_block", _rec(trace=tr, trace_blocks=4)) == pytest.approx(100.0)
    assert _read("device_idle_share", _rec(trace={"busy_s": 0.0, "window_s": 2.0})) is None
    assert _read("decode_slot_yield", _rec(bursts=8, bursts_framed=6)) == 75.0
    assert _read("host_output_ms_per_block", _rec(blocks=4, output_s=0.2)) == pytest.approx(50.0)


def _airspy(cfg):
    """rtl8's plan as the Airspy R2 takes it: f32real at 5 Msps, fc by the
    port's air.c rule."""
    from vdlm2dec_tpu_torch.io.sdr import choose_fc_airspy

    cfg.update(format="f32real", fs=5_000_000)
    cfg["fc_hz"] = choose_fc_airspy(gen.channel_plan(cfg), cfg["fs"])
    return cfg


@pytest.mark.parametrize("fmt", ["cu8", "f32real"])
def test_sync_fit_reads_each_burst_frequency_offset(fmt):
    """The float64 sync fit, at the trigger sample that ends a burst's sync
    word, reads the offset the generator gave the burst (to a few Hz: the
    fit sees the pulse's intersymbol interference, as the decoder does);
    f32real channels sit at their offsets from F0 = fc + fs/4."""
    cfg = json.load(open(os.path.join(cells.BENCH_DIR, "configs", "rtl8.json")))
    tr = json.load(open(os.path.join(cells.BENCH_DIR, "traffic", "busy-file.json")))
    cfg["channels"], tr["seconds"] = 2, 1.0
    if fmt == "f32real":
        cfg = _airspy(cfg)
    cap = gen.make_capture(cfg, tr, 5, "cpu")
    assert cap.bursts and cap.fmt == fmt
    f0 = protocol.mix_center_hz(fmt, cap.fs, cap.fc_hz)
    for b in cap.bursts:
        fit = reference.sync_slope_hz(cap.raw, cap.fmt, cap.fs, cap.freqs_hz[b.chan] - f0,
                                      np.arange(b.start + 136, b.start + 142))
        assert np.min(np.abs(fit - b.imp[0])) < 10.0


def test_f32real_front_is_the_ports_channelizer():
    """The reference's float64 front over f32real samples (real, mixed
    relative to F0) against the port's plain dft channelizer under
    real_input on the same samples: the same 84 kHz samples to float32
    rounding."""
    import torch

    from vdlm2dec_tpu_torch import pipeline as pl

    cfg = json.load(open(os.path.join(cells.BENCH_DIR, "configs", "rtl8.json")))
    tr = json.load(open(os.path.join(cells.BENCH_DIR, "traffic", "busy-file.json")))
    cfg["channels"], tr["seconds"] = 2, 0.5
    cap = gen.make_capture(_airspy(cfg), tr, 5, "cpu")
    ch = pl.Pipeline(drive.pipeline_config(cfg), "cpu").channelizer
    assert ch.real_input and ch.impl == "dft"
    x = torch.from_numpy(cap.raw[: len(cap.raw) - len(cap.raw) % ch.p_in])
    y = ch.channelize(x).numpy()
    f0 = protocol.mix_center_hz("f32real", cap.fs, cap.fc_hz)
    for ci, f in enumerate(cap.freqs_hz):
        ref = reference._decimate(cap.raw, "f32real", cap.fs, f - f0, 0, y.shape[1])
        got = y[ci, :, 0] + 1j * y[ci, :, 1]
        assert np.abs(ref).max() > 1e-3
        assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


def test_slope_gaps_sample_and_skip_the_stream_start():
    raw = np.full(2 * 2_000_000, 127, dtype=np.uint8)
    # (channel, t0, offset Hz) rows, flat, as drive.Record.soft keeps them
    soft = [0, 100, 5.0, 0, 1000, 0.0, 0, 2000, 0.0, 1, 3000, 0.25]
    gaps = reference.slope_gaps(raw, "cu8", 2_000_000, 136_500_000, [136_600_000, 136_650_000],
                                soft, 2, seed=3)
    # the burst at t0 100 has no history in the stream; two of the rest
    assert len(gaps) == 2 and np.all(np.isfinite(gaps))


def test_sync_error_is_the_program_s_own_metric():
    """The float64 sync error from the capture's bytes reads what the
    program's sync scan reads at every odd sample, and dips far under the
    threshold 136 or so samples after each burst's first sample."""
    import torch

    from vdlm2dec_tpu_torch import pipeline as pl
    from vdlm2dec_tpu_torch.ops.sync import sync_scan

    cfg = json.load(open(os.path.join(cells.BENCH_DIR, "configs", "rtl8.json")))
    tr = json.load(open(os.path.join(cells.BENCH_DIR, "traffic", "busy-file.json")))
    cfg["channels"], tr["seconds"] = 2, 0.5
    cap = gen.make_capture(cfg, tr, 5, "cpu")
    pipe = pl.Pipeline(drive.pipeline_config(cfg), "cpu")
    x = (cap.raw.astype(np.float32) - 127.37).reshape(-1, 2)
    x = x[: len(x) - len(x) % pipe.channelizer.p_in]
    err, _fr = sync_scan(pipe.channelizer.channelize(torch.tensor(x)).contiguous(), "stream")
    for ci in range(2):
        t, e = reference.sync_errors(cap.raw, cap.fmt, cap.fs, cap.freqs_hz[ci] - cap.fc_hz, 1001, 40000)
        low = e < 10
        assert low.sum() > 10
        assert np.max(np.abs(err[ci, t].numpy() - e)[low]) < 1e-3
    assert cap.bursts
    for b in cap.bursts:
        t, e = reference.sync_errors(cap.raw, cap.fmt, cap.fs, cap.freqs_hz[b.chan] - cap.fc_hz,
                                     b.start - 20, b.start + 180)
        assert 134 <= t[np.argmin(e)] - b.start <= 140 and e.min() < 0.2
    assert reference.unsyncable(cap.raw, cap.fmt, cap.fs, cap.fc_hz, cap.freqs_hz, cap.bursts) == []


@pytest.mark.parametrize("early, is_owed", [
    (None, True),            # a clean preamble
    ((31, 3.46), False),     # a dip under the threshold 106 samples before
    ((31, 4.03), False),     # one just over it, inside the float32 slack
    ((31, 4.5), True),       # one clearly over it
    ((-11, 3.0), True),      # one more than a sync window before
    ((101, 3.0), False),     # a trigger on the sync word's own first symbols
])
def test_owed_by_the_sync_rule(early, is_owed):
    start = 1000
    t = np.arange(start - 60, start + 200, 2) + 1
    err = 50.0 - 49.99 * (np.abs(t - (start + 137)) < 40) * (1 - np.abs(t - (start + 137)) / 40)
    if early is not None:
        off, depth = early
        err = np.where(np.abs(t - (start + off)) < 8, depth + 0.1 * np.abs(t - (start + off)), err)
    assert reference.owed(t, err, start) is is_owed


def test_owed_needs_a_clear_sync_point():
    start = 1000
    t = np.arange(start - 60, start + 200, 2) + 1
    assert not reference.owed(t, np.full(len(t), 50.0), start)
    err = np.where(np.abs(t - (start + 137)) < 8, 2.0 + 0.1 * np.abs(t - (start + 137)), 50.0)
    assert not reference.owed(t, err, start)


def test_a_wrong_line_for_a_burst_not_owed_counts():
    class J:
        def locate(self, line):
            return {"a": (0, 0, True), "b": (1, 0, False)}[line]

    t = reference.tally(J(), [(1, "a"), (1, "b")], [(1, 0, 0)], excused={1})
    assert (t["attempted"], t["missed"], t["wrong"], t["extra"]) == (1, 0, 1, 0)
    t = reference.tally(J(), [(1, "a")], [(1, 0, 0)], excused={1})
    assert (t["missed"], t["wrong"], t["extra"]) == (0, 0, 0)
