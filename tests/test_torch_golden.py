"""The port's device stages held directly against the port's golden model.

The counterparts of tests/test_ops_vs_golden.py, tests/test_golden_e2e.py
and tests/test_airspy_e2e.py: the same seeded numpy inputs, the port's
`ops` on the CPU (where the kernels' wrappers run their plain versions)
against the port's own copy of the scalar model (`golden/dsp.py`,
`golden/codec.py`), at the tolerances those tests state.  Nothing of the
JAX package is imported here.
"""
import numpy as np
import pytest
import torch

from vdlm2dec_tpu_torch import constants as C
from vdlm2dec_tpu_torch import framegen as fg
from vdlm2dec_tpu_torch import modulator as mod
from vdlm2dec_tpu_torch._tables import MAX_TX_BYTES, PipelineConfig
from vdlm2dec_tpu_torch.golden import codec
from vdlm2dec_tpu_torch.golden.dsp import GoldenChannel, mix_and_decimate
from vdlm2dec_tpu_torch.ops import assembly, demod, header, rs_fec, sync
from vdlm2dec_tpu_torch.ops.channelizer import Channelizer
from vdlm2dec_tpu_torch.pipeline import Pipeline

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

TWO_PI = 2 * np.pi


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cplx(y: torch.Tensor) -> np.ndarray:
    y = y.numpy()
    return y[..., 0] + 1j * y[..., 1]


# ---------------------------------------------------------------- channelizer

@pytest.mark.parametrize("impl", ["matmul", "dft", "pfb"])
def test_channelizer_matches_reference_decimator(impl):
    rng = np.random.default_rng(0)
    fs, sdrclk = 2_000_000, 500
    t = 3 * 4 * sdrclk
    x = (rng.normal(size=t) + 1j * rng.normal(size=t)).astype(np.complex64)
    offsets = [25_000.0, -75_000.0, 150_000.0]
    chan = Channelizer(offsets, fs=fs, sdrclk=sdrclk, lo_wrap=True, impl=impl)
    yc = _cplx(chan.channelize(x))
    for ci, fo in enumerate(offsets):
        ref = mix_and_decimate(x, fo, fs, sdrclk, lo_table_wrap=True)
        assert yc.shape[1] == len(ref)
        np.testing.assert_allclose(yc[ci], ref, atol=2e-5)


def test_channelizer_streaming_continuity():
    """Two half-blocks must equal one full block (period phase carry)."""
    rng = np.random.default_rng(1)
    fs, sdrclk = 2_000_000, 500
    p = 4 * sdrclk
    x = (rng.normal(size=4 * p)
         + 1j * rng.normal(size=4 * p)).astype(np.complex64)
    chan1 = Channelizer([30_000.0], fs=fs, lo_wrap=False, impl="matmul")
    full = chan1.channelize(x).numpy()
    chan2 = Channelizer([30_000.0], fs=fs, lo_wrap=False, impl="matmul")
    a = chan2.channelize(x[: 2 * p]).numpy()
    b = chan2.channelize(x[2 * p:]).numpy()
    np.testing.assert_allclose(np.concatenate([a, b], axis=1), full, atol=2e-5)
    # and the whole block is the reference decimator's continuous LO
    ref = mix_and_decimate(x, 30_000.0, fs, sdrclk, lo_table_wrap=False)
    np.testing.assert_allclose(full[0, :, 0] + 1j * full[0, :, 1], ref,
                               atol=2e-5)


@pytest.mark.parametrize("fs,sdrclk", [(5_000_000, 1250), (6_000_000, 1500)])
def test_channelizer_airspy_rates(fs, sdrclk):
    rng = np.random.default_rng(2)
    p = 4 * sdrclk
    x = rng.normal(size=2 * p).astype(np.float32)     # real input
    ref = mix_and_decimate(x.astype(np.complex64), -1_200_000.0, fs, sdrclk)
    for impl in ("matmul", "dft"):
        chan = Channelizer([-1_200_000.0], fs=fs, sdrclk=sdrclk,
                           real_input=True, impl=impl)
        yc = _cplx(chan.channelize(x))
        assert yc.shape[1] == len(ref) == 168
        np.testing.assert_allclose(yc[0], ref, atol=2e-5)


# ---------------------------------------------------------------- sync metric

def _golden_trace(sig):
    ch = GoldenChannel()
    ch.run(sig)
    return ch


def _streams(sig) -> torch.Tensor:
    return _t(demod.pack_complex(sig[None, :]))


@pytest.mark.parametrize("mode", sync.MODES)
def test_sync_metric_matches_golden(mode):
    rng = np.random.default_rng(3)
    content = rng.integers(0, 256, 30).astype(np.uint8)
    plan = mod.make_burst([content])
    sig = mod.synthesize_baseband(plan, start=400, cfo_hz=80.0)
    sig = mod.awgn(sig, 18.0, rng)
    gch = _golden_trace(sig)

    err, fr = (v.numpy()[0] for v in sync.sync_scan(_streams(sig), mode))

    # golden records (t, err, fr) for every sync metric position.  Compare
    # only up to the first trigger: after a burst the serial decoder's phase
    # ring is stale (frozen during the burst) while the batched scan uses
    # true phases, an intentional divergence handled by overlap filtering.
    first_trigger = gch.bursts[0].start_index if gch.bursts else len(err)
    checked = 0
    for (t, ge, gf) in gch.sync_errs:
        if t < 200 or t >= first_trigger:
            continue
        assert err[t] == pytest.approx(ge, abs=2e-3), f"err mismatch at t={t}"
        assert fr[t] == pytest.approx(gf, abs=1e-4), f"fr mismatch at t={t}"
        checked += 1
    assert checked > 50


def test_triggers_match_golden():
    rng = np.random.default_rng(4)
    content = rng.integers(0, 256, 30).astype(np.uint8)
    plan = mod.make_burst([content])
    sig = mod.synthesize_baseband(plan, start=500, timing_frac=0.4)
    sig = mod.awgn(sig, 15.0, rng)
    gch = _golden_trace(sig)
    assert len(gch.bursts) == 1
    gb = gch.bursts[0]

    err, fr = sync.sync_scan(_streams(sig))
    t0, of, df, valid, _q = demod.find_triggers(err, fr, 4)
    assert bool(valid[0, 0])
    assert int(t0[0, 0]) == gb.start_index
    assert float(of[0, 0]) == pytest.approx(gb.timing, abs=1e-2)
    assert float(df[0, 0]) == pytest.approx(gb.freq_offset, abs=1e-5)


def test_find_triggers_block_compaction_parity():
    """The earliest-K selection against a brute-force numpy replay of the
    trigger / suppression / selection rules, with planted triggers
    straddling 128-sample seams, closer than the 137-sample suppression
    window, and in the tail."""
    rng = np.random.default_rng(11)
    c, t = 3, 4000
    err = rng.normal(size=(c, t)).astype(np.float32) + 10.0   # no triggers
    fr = rng.normal(size=(c, t)).astype(np.float32) * 1e-3
    spots = [(0, 201), (0, 255), (0, 257), (0, 511), (0, 513),
             (1, 1023), (1, 1101), (1, 2049),
             (2, 3901), (2, 3999)]
    for ci, tp in spots:
        err[ci, tp - 2] = 0.0          # e1 < threshold
        err[ci, tp] = 5.0              # e0 > e1

    k = 4
    t0, _of, _df, valid, _q = demod.find_triggers(_t(err), _t(fr), k)

    e1 = np.pad(err, ((0, 0), (2, 0)))[:, :t]
    exp, n_kept = [], 0
    for ci in range(c):
        fired = [tp for tp in range(150, t)
                 if tp % 2 and e1[ci, tp] < 4.0 and err[ci, tp] > e1[ci, tp]]
        kept, last_any = [], -10**9
        for tp in fired:
            if tp - last_any > 136:
                kept.append(tp)
            last_any = tp              # ANY trigger suppresses followers
        # invalid slots come back clamped to t-1 with valid=False
        exp.append((kept[:k] + [t - 1] * k)[:k])
        n_kept += min(k, len(kept))
    np.testing.assert_array_equal(t0.numpy(), np.array(exp))
    assert int(valid.sum()) == n_kept


# ---------------------------------------------------------------- demod block

@pytest.mark.parametrize("form", ["flat", "inline"])
def test_demod_block_matches_golden(form):
    rng = np.random.default_rng(5)
    content = rng.integers(0, 256, 60).astype(np.uint8)
    plan = mod.make_burst([content])
    sig = mod.synthesize_baseband(plan, start=400, cfo_hz=120.0,
                                  timing_frac=0.6)
    sig = mod.awgn(sig, 14.0, rng)
    gch = _golden_trace(sig)
    assert len(gch.bursts) == 1
    gb = gch.bursts[0]

    max_symbols = 1024
    y = _streams(sig)
    err, fr = sync.sync_scan(y)
    t0, of, df, _valid, _q = demod.find_triggers(err, fr, 4)
    chan = torch.zeros(4, dtype=torch.int32)
    if form == "flat":
        soft = demod.demod_candidates_flat(y, chan, t0[0], of[0], df[0],
                                           max_symbols,
                                           demod.polyphase_filter(y))
    else:
        soft = demod.demod_candidates_inline(y, chan, t0[0], of[0], df[0],
                                             max_symbols)
    flat = soft[0]

    length, nbrow, nlbyte, ok = header.header_decode(flat[None, :25])
    assert bool(ok[0])
    assert int(length[0]) == gb.length_bits
    assert int(nbrow[0]) == gb.nbrow
    assert int(nlbyte[0]) == gb.nlbyte

    need = 8 * MAX_TX_BYTES
    data_soft = flat[25: 25 + need]
    data_soft = torch.nn.functional.pad(data_soft,
                                        (0, need - data_soft.shape[0]))
    blocks, _consumed = assembly.assemble_blocks(data_soft[None, :], nbrow,
                                                 nlbyte)
    np.testing.assert_array_equal(blocks.numpy()[0, : gb.nbrow], gb.block)


# ---------------------------------------------------------------- RS

def _random_codeword(rng):
    data = rng.integers(0, 256, C.RS_K).astype(np.uint8)
    return np.concatenate([data, codec.rs_encode_row(data)])


def test_rs_rows_match_golden():
    rng = np.random.default_rng(6)
    rows, classes, want_rows, want_counts = [], [], [], []
    for _trial in range(24):
        bad = _random_codeword(rng)
        nerr = int(rng.integers(0, 5))
        for p in rng.choice(C.RS_N, nerr, replace=False):
            bad[p] ^= int(rng.integers(1, 256))
        cls = int(rng.integers(0, 3))
        eras = [[], [253, 254], [251, 252, 253, 254]][cls]
        for e in eras:
            bad[e] = 0
        g_out, g_cnt = codec.rs_decode_row(bad, eras)
        rows.append(bad)
        classes.append(cls)
        want_rows.append(g_out)
        want_counts.append(g_cnt)
    got_rows, got_counts = (v.numpy() for v in rs_fec.rs_decode_rows(
        _t(np.stack(rows)), _t(np.asarray(classes, np.int32))))
    for i in range(len(rows)):
        assert got_counts[i] == want_counts[i], f"count mismatch @{i}"
        np.testing.assert_array_equal(got_rows[i], want_rows[i],
                                      err_msg=f"row {i}")


def test_rs_rows_uncorrectable_matches_golden():
    rng = np.random.default_rng(7)
    rows, want_counts = [], []
    for _trial in range(8):
        bad = _random_codeword(rng)
        for p in rng.choice(C.RS_N, 8, replace=False):
            bad[p] ^= int(rng.integers(1, 256))
        _, g_cnt = codec.rs_decode_row(bad, [])
        rows.append(bad)
        want_counts.append(g_cnt)
    _, got_counts = rs_fec.rs_decode_rows(
        _t(np.stack(rows)), torch.zeros(len(rows), dtype=torch.int32))
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)


# ---------------------------------------------------------------- header

def test_header_decode_batch():
    rng = np.random.default_rng(8)
    softs, want = [], []
    for _ in range(32):
        length = int(rng.integers(96, 8 * 1992))
        bits = codec.header_encode(length)
        soft = np.clip(bits.astype(np.float64) * 0.96 + 0.02
                       + rng.normal(0, 0.05, 25), 0.001, 0.999)
        g_len, _ = codec.header_decode_soft(soft)
        softs.append(soft)
        want.append(g_len)
    length, _nbrow, _nlbyte, _ok = header.header_decode(
        _t(np.stack(softs).astype(np.float32)))
    np.testing.assert_array_equal(length.numpy(), want)


# ------------------------------------- the golden model end to end (numpy only)

def _frames_of(burst):
    return codec.deframe_block(burst.block, burst.nbrow, burst.nlbyte)[0]


def _one_frame(sig, content):
    bursts = GoldenChannel().run(sig)
    assert len(bursts) == 1, f"expected 1 burst, got {len(bursts)}"
    frames = _frames_of(bursts[0])
    assert len(frames) == 1
    assert np.array_equal(frames[0][1:-3], content)
    return bursts[0]


@pytest.mark.parametrize("timing_frac", [0.0, 0.3, 0.7])
def test_e2e_clean_baseband(timing_frac):
    rng = np.random.default_rng(42)
    content = rng.integers(0, 256, 39).astype(np.uint8)
    plan = mod.make_burst([content])
    sig = mod.synthesize_baseband(plan, start=200, timing_frac=timing_frac)
    assert _one_frame(sig, content).length_bits == plan.length_bits


def test_e2e_cfo_and_phase():
    rng = np.random.default_rng(43)
    content = rng.integers(0, 256, 69).astype(np.uint8)
    plan = mod.make_burst([content])
    # ~ +/-400 Hz CFO is ~ 4 ppm at VHF; demod estimates and removes it
    _one_frame(mod.synthesize_baseband(plan, start=300, cfo_hz=200.0,
                                       phase0=1.1), content)


def test_e2e_noise_10db():
    rng = np.random.default_rng(44)
    content = rng.integers(0, 256, 49).astype(np.uint8)
    plan = mod.make_burst([content])
    sig = mod.awgn(mod.synthesize_baseband(plan, start=250), 10.0, rng)
    _one_frame(sig, content)


def test_e2e_multirow():
    rng = np.random.default_rng(45)
    content = rng.integers(0, 256, 400).astype(np.uint8)   # forces 2 RS rows
    plan = mod.make_burst([content])
    assert plan.nbrow >= 2
    _one_frame(mod.synthesize_baseband(plan, start=200), content)


def test_e2e_wideband_channelized():
    """Burst placed at +Fo in a 2.0 Msps wideband, then the reference
    mixer/decimator brings it back to 84 kHz."""
    rng = np.random.default_rng(46)
    content = rng.integers(0, 256, 39).astype(np.uint8)
    plan = mod.make_burst([content])
    bb = mod.synthesize_baseband(plan, start=220)
    fs, sdrclk = 2_000_000, 500
    f_off = 75_000.0          # 3 channels up: multiple of 25 kHz
    wide = mod.upsample_to_wideband(bb, fs, f_off)
    _one_frame(mix_and_decimate(wide, f_off, fs, sdrclk), content)


# ---------------------------------------------------------------- airspy e2e

@pytest.mark.parametrize("fs,sdrclk", [(6_000_000, 1500), (5_000_000, 1250)])
def test_airspy_real_capture_decodes(fs, sdrclk):
    """Real f32 capture at 6 Msps (Mini) / 5 Msps (R2): channels mixed
    relative to F0 = Fc + fs/4 (air.c:182-185); the channel's
    conjugate-symmetric image lies far outside the decimator passband."""
    rng = np.random.default_rng(0)
    freq = 136_975_000
    fc = 136_800_000
    fo = freq - (fc + fs / 4)            # negative: below F0

    content = fg.acars_frame(text=f"AIRSPY{fs}", label="Q0")
    plan = mod.make_burst([content])
    bb = mod.synthesize_baseband(plan, start=600, total=2 * 8400)
    # real capture: Re{a(t) e^{j 2 pi fo t}} * 2 puts the channel at fo
    # relative to F0 with a conjugate image at -fo (|2 fo| ~ fs/2, rejected)
    ratio = fs / 84_000
    n = int(len(bb) * ratio)
    tt = np.arange(n) / ratio
    i0 = np.clip(np.floor(tt).astype(int), 0, len(bb) - 2)
    frac = tt - i0
    up = bb[i0] * (1 - frac) + bb[i0 + 1] * frac
    real_sig = 2.0 * np.real(up * np.exp(1j * TWO_PI * fo / fs * np.arange(n)))
    real_sig = (real_sig * 30 + rng.normal(size=n)).astype(np.float32)

    cfg = PipelineConfig(
        freqs_hz=[float(freq)], fs=fs, fc_hz=float(fc), real_input=True,
        sdrclk=sdrclk, max_symbols=512, max_candidates=8,
    )
    bursts = Pipeline(cfg, device="cpu").decode_wideband(real_sig)
    frames = [f for b in bursts for f in b.frames]
    assert len(frames) == 1
    np.testing.assert_array_equal(frames[0][1:-3], content)
