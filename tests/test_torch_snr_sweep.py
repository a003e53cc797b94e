"""SNR sweep of the port: decode probability against SNR.

The counterparts of tests/test_snr_sweep.py on the port's Pipeline (on the
CPU) against the port's golden scalar chain: at high SNR both decode
everything, near threshold the recall difference stays small (same
matched filter, same soft metrics).  Then the sweep module itself, and
one test that the port and the JAX package decode the same trials of one
seed at 8 dB.
"""
import json

import numpy as np
import pytest
import torch

from vdlm2dec_tpu.pipeline import Pipeline as JaxPipeline
from vdlm2dec_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from vdlm2dec_tpu_torch import modulator as mod
from vdlm2dec_tpu_torch import snr_sweep
from vdlm2dec_tpu_torch._tables import PipelineConfig
from vdlm2dec_tpu_torch.golden.codec import deframe_block
from vdlm2dec_tpu_torch.golden.dsp import GoldenChannel
from vdlm2dec_tpu_torch.pipeline import Pipeline

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

ONE_CHANNEL = dict(freqs_hz=[136_975_000.0], fc_hz=136_900_000.0,
                   max_symbols=512, max_candidates=4)


def _pipe():
    return Pipeline(PipelineConfig(**ONE_CHANNEL), device="cpu")


def _decoded(bursts, content) -> bool:
    return any(np.array_equal(f[1:-3], content)
               for b in bursts for f in b.frames)


def _trial(rng, snr_db, n=8):
    """(golden_ok, port_ok) decode counts over n bursts."""
    pipe = _pipe()
    g_ok = p_ok = 0
    for _ in range(n):
        content = rng.integers(0, 256, 30).astype(np.uint8)
        plan = mod.make_burst([content])
        sig = mod.synthesize_baseband(plan, start=400, total=2000,
                                      timing_frac=float(rng.random()))
        sig = mod.awgn(sig, snr_db, rng)
        for b in GoldenChannel().run(sig):
            frames, _ = deframe_block(b.block, b.nbrow, b.nlbyte)
            if any(np.array_equal(f[1:-3], content) for f in frames):
                g_ok += 1
        p_ok += _decoded(
            pipe.decode_channels(sig[None, :].astype(np.complex64)), content)
    return g_ok, p_ok


def test_high_snr_both_perfect():
    g, p = _trial(np.random.default_rng(0), 20.0, n=6)
    assert g == 6 and p == 6


def test_mid_snr_parity():
    g, p = _trial(np.random.default_rng(1), 8.0, n=10)
    # same soft chain: recall within 2 bursts of each other
    assert abs(g - p) <= 2
    assert p >= 8            # 8 dB decodes reliably


def test_threshold_snr_not_worse():
    g, p = _trial(np.random.default_rng(2), 4.0, n=10)
    assert p >= g - 2


def test_large_cfo_tolerance():
    """CFO up to ~800 Hz (8 ppm at VHF): the LS slope estimator + per-burst
    df correction must still decode; the ppm estimate must track."""
    rng = np.random.default_rng(5)
    pipe = _pipe()
    for cfo in (-800.0, -300.0, 300.0, 800.0):
        content = rng.integers(0, 256, 30).astype(np.uint8)
        plan = mod.make_burst([content])
        sig = mod.synthesize_baseband(plan, start=400, total=2500, cfo_hz=cfo)
        sig = mod.awgn(sig, 15.0, rng)
        bursts = [b for b in pipe.decode_channels(
            sig[None, :].astype(np.complex64)) if b.frames]
        assert len(bursts) == 1, f"CFO {cfo} Hz failed"
        assert bursts[0].ppm == pytest.approx(cfo / 136.975e6 * 1e6, abs=0.5)


@pytest.mark.parametrize("cfo_hz", [-400.0, -150.0, 150.0, 400.0])
def test_cfo_tolerance_and_ppm_estimate(cfo_hz):
    """Bursts with carrier-frequency offset decode (the sync LS slope
    absorbs CFO, d8psk.c:260-283) and the per-burst ppm estimate
    (d8psk.c:302) recovers the injected offset."""
    rng = np.random.default_rng(int(abs(cfo_hz)))
    content = rng.integers(0, 256, 30).astype(np.uint8)
    plan = mod.make_burst([content])
    sig = mod.synthesize_baseband(plan, start=400, total=2500, cfo_hz=cfo_hz)
    sig = mod.awgn(sig, 15.0, rng)
    bursts = _pipe().decode_channels(sig[None, :].astype(np.complex64))
    ok = [b for b in bursts if _decoded([b], content)]
    assert ok, f"no decode at {cfo_hz} Hz CFO"
    assert ok[0].ppm == pytest.approx(cfo_hz / 136.975e6 * 1e6, abs=0.35)


def test_snr_sweep_64_channels():
    """64 channels decoding at once with per-channel SNR spread over 2-20
    dB: high-SNR channels all decode, threshold channels degrade
    gracefully, and no frame appears on a channel it was not sent on."""
    rng = np.random.default_rng(9)
    n_chan, t = 64, 3000
    snrs = np.linspace(2.0, 20.0, n_chan)
    y = np.zeros((n_chan, t), dtype=np.complex128)
    contents = {}
    for ci in range(n_chan):
        c = rng.integers(0, 256, 24).astype(np.uint8)
        contents[ci] = c
        sig = mod.synthesize_baseband(mod.make_burst([c]), start=500, total=t)
        y[ci] = mod.awgn(sig, float(snrs[ci]), rng)

    freqs = [118_025_000.0 + 25_000 * 12 * ci for ci in range(n_chan)]
    cfg = PipelineConfig(freqs_hz=freqs, fc_hz=128_000_000.0,
                         max_symbols=512, max_candidates=4)
    bursts = Pipeline(cfg, device="cpu").decode_channels(
        y.astype(np.complex64))
    ok = {b.channel for b in bursts if _decoded([b], contents[b.channel])}
    high = {ci for ci in range(n_chan) if snrs[ci] >= 12.0}
    assert high <= ok, f"missing high-SNR channels: {sorted(high - ok)}"
    # threshold region: single-shot bursts at 6-12 dB sit at the RS
    # correction limit, so about half decode: graceful, not a cliff
    mid = [ci for ci in range(n_chan) if 6.0 <= snrs[ci] < 12.0]
    assert sum(ci in ok for ci in mid) >= len(mid) * 0.4, (
        "threshold-region recall collapsed")
    for b in bursts:
        for f in b.frames:
            assert not any(ci != b.channel and np.array_equal(f[1:-3], c)
                           for ci, c in contents.items()), \
                "cross-channel frame leakage"


def test_sweep_rows_and_cli(capsys):
    """The module's rows: port_rate (and golden_rate with --golden) per
    SNR point; both are 1.0 at 20 dB."""
    assert snr_sweep.main(["--device", "cpu", "--trials", "3", "--snrs", "3",
                           "20", "--golden", "--payload", "30"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["snr_db"] for r in rows] == [3.0, 20.0]
    assert rows[1] == {"snr_db": 20.0, "port_rate": 1.0, "golden_rate": 1.0}
    assert rows[0]["port_rate"] <= 1.0 and "tpu_rate" not in rows[0]
    plain = list(snr_sweep.sweep([20.0], 2, 30, False, "cpu"))
    assert plain == [{"snr_db": 20.0, "port_rate": 1.0}]


def test_port_and_jax_decode_the_same_trials_at_8db():
    """One seed, 10 trials at 8 dB (some decode, some may not): the port's
    and the JAX package's decode_channels recover the same set."""
    rng = np.random.default_rng(21)
    pipe = _pipe()
    jpipe = JaxPipeline(JaxPipelineConfig(**ONE_CHANNEL))
    got_p, got_j = set(), set()
    for trial in range(10):
        content = rng.integers(0, 256, 30).astype(np.uint8)
        plan = mod.make_burst([content])
        sig = mod.synthesize_baseband(plan, start=400, total=2000,
                                      timing_frac=float(rng.random()),
                                      cfo_hz=float(rng.normal(0, 100)))
        y = mod.awgn(sig, 8.0, rng)[None, :].astype(np.complex64)
        if _decoded(pipe.decode_channels(y), content):
            got_p.add(trial)
        if _decoded(jpipe.decode_channels(y), content):
            got_j.add(trial)
    assert got_p == got_j
    assert len(got_p) >= 5          # 8 dB with CFO: most trials decode
