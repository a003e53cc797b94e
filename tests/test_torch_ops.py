"""Each device stage of the PyTorch port against its JAX twin on the CPU.

Both sides get the same inputs, made from numpy seeds; where the JAX path
reaches the Pallas sync kernel it runs in interpret mode, as
tests/test_fused_sync.py runs it.  Tolerances are stated beside each
comparison with their reason; integer and byte outputs are exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as B
from vdlm2dec_tpu import constants as C
from vdlm2dec_tpu.golden import codec
from vdlm2dec_tpu.ops import assembly as jasm
from vdlm2dec_tpu.ops import channelizer as jch
from vdlm2dec_tpu.ops import demod as jdemod
from vdlm2dec_tpu.ops import header as jhdr
from vdlm2dec_tpu.ops import rs_fec as jrs
from vdlm2dec_tpu.ops.pallas_channelizer import channelize_u8_pallas
from vdlm2dec_tpu.ops.pallas_sync import sync_scan_pallas
from vdlm2dec_tpu.pipeline import _raw_to_planes, _raw_to_planes_split
from vdlm2dec_tpu_torch.golden.dsp import mix_and_decimate
from vdlm2dec_tpu_torch.ops import assembly, chan_u8, demod, header, rs_fec, sync
from vdlm2dec_tpu_torch.ops.channelizer import (
    Channelizer,
    channelize_matmul,
    channelize_pfb,
)
from vdlm2dec_tpu_torch.ops.ingest import (
    DC_OFFSET,
    raw_to_planes,
    raw_to_planes_split,
)

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

P_IN = 2000

# sync metric tolerances (as tests/test_fused_sync.py): the two packages
# share the operation order but not the atan2 (XLA's and PyTorch's CPU
# atan2 differ in the last ulp), and err sums 17 squared residuals
ERR_TOL = dict(rtol=1e-4, atol=1e-4)
FR_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def capture():
    """2 channels, 0.5 s of dense impaired bursts, as cu8 bytes."""
    wide, freqs, fc, truth = B.make_capture(2_000_000, 2, 0.5)
    raw = B.to_u8(wide[: len(wide) - len(wide) % P_IN])
    return raw, freqs, fc


@pytest.fixture(scope="module")
def decimated(capture):
    """(C, T, 2) float32 decimated streams of the capture."""
    raw, freqs, fc = capture
    offsets = [f - fc for f in freqs]
    ch = Channelizer(offsets, fs=2_000_000)
    x_r, x_i = raw_to_planes_split(_t(raw), P_IN)
    return ch(x_r, x_i, split=True).numpy()


# ---------------------------------------------------------------- ingest

def test_ingest_split_planes_exact():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, 8 * P_IN * 2).astype(np.uint8)
    xr_j, xi_j = _raw_to_planes_split(jnp.asarray(raw), jnp.float32(127.37),
                                      P_IN)
    xr_t, xi_t = raw_to_planes_split(_t(raw), P_IN)
    np.testing.assert_array_equal(xr_t.numpy(), np.asarray(xr_j))
    np.testing.assert_array_equal(xi_t.numpy(), np.asarray(xi_j))
    # and against a plain deinterleave through the split-phase index
    sp = jch.split_phase_index(np.arange(P_IN), P_IN)
    want = (raw[0::2].astype(np.float32) - np.float32(127.37)).reshape(-1, P_IN)
    np.testing.assert_array_equal(xr_t.numpy()[:, sp], want)
    assert DC_OFFSET == float(np.float32(127.37))


def _raw_of(fmt, n_periods, rng):
    n = n_periods * P_IN * (1 if fmt == "f32real" else 2)
    if fmt == "cu8":
        return rng.integers(0, 256, n).astype(np.uint8)
    if fmt == "cs16":
        raw = rng.integers(-32768, 32768, n).astype(np.int16)
        raw[:4] = [-32768, 32767, -1, 0]
        return raw
    return (rng.normal(size=n) * 100).astype(np.float32)


@pytest.mark.parametrize("fmt", ["cu8", "cs16", "cf32", "f32real"])
def test_raw_to_planes_exact(fmt):
    """Sample-order planes of every capture format equal the JAX
    package's bit for bit: integer -> float32 conversions and copies."""
    raw = _raw_of(fmt, 5, np.random.default_rng(3))
    want = [np.asarray(v) for v in _raw_to_planes(
        jnp.asarray(raw), fmt, jnp.float32(127.37), P_IN)]
    got = [v.numpy() for v in raw_to_planes(_t(raw), fmt, P_IN)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (5, P_IN)
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):              # each format its dtype
        other = np.int16 if raw.dtype != np.int16 else np.uint8
        raw_to_planes(_t(raw.astype(other)), fmt, P_IN)


def test_ingest_rejects_partial_periods():
    with pytest.raises(ValueError):
        raw_to_planes_split(torch.zeros(P_IN * 2 + 4, dtype=torch.uint8), P_IN)


# ---------------------------------------------------------------- channelizer

# channelizer tolerance: z is a single product per cell on both sides
# (exact); y sums tbl = 80 products of |x| <= 128 in a different order,
# so it agrees to a few float32 ulps of the 8-bit input scale
CHAN_ATOL = 2e-4


@pytest.mark.parametrize("split", [True, False])
def test_channelizer_matches_jax(split):
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, 6 * P_IN * 2).astype(np.uint8)
    offsets = (-275_000.0, 25_000.0, 350_000.0)
    jc = jch.Channelizer(offsets, fs=2_000_000, lo_wrap=True, impl="dft")
    w_r, w_i, a2 = (np.asarray(v) for v in jc.qr_tables(split))
    sfx = "s" if split else "n"
    tc = Channelizer.from_numpy_tables(
        offsets, {f"w_r_{sfx}": w_r, f"w_i_{sfx}": w_i, f"a2_{sfx}": a2},
        period_cursor=7)
    if split:
        x_r, x_i = _raw_to_planes_split(jnp.asarray(raw), jnp.float32(127.37),
                                        P_IN)
    else:
        x_r, x_i = _raw_to_planes(jnp.asarray(raw), "cu8",
                                  jnp.float32(127.37), P_IN)
    yr_j, yi_j = jch._channelize_dft_qr_jit(x_r, x_i, *jc.qr_tables(split),
                                            split=split)
    y = tc(_t(np.asarray(x_r)), _t(np.asarray(x_i)), split=split).numpy()
    assert y.shape == (3, 6 * 84, 2)
    np.testing.assert_allclose(y[..., 0], np.asarray(yr_j), rtol=0,
                               atol=CHAN_ATOL)
    np.testing.assert_allclose(y[..., 1], np.asarray(yi_j), rtol=0,
                               atol=CHAN_ATOL)
    assert tc._period_cursor == 7 + 6
    tc(_t(np.asarray(x_r)), _t(np.asarray(x_i)), split=split, period0=0)
    assert tc._period_cursor == 13


def test_channelizer_own_tables_equal_carried_tables():
    offsets = (-275_000.0, 25_000.0)
    jc = jch.Channelizer(offsets, fs=2_000_000, lo_wrap=True, impl="dft")
    tc = Channelizer(offsets, fs=2_000_000)
    for split in (True, False):
        for mine, theirs in zip(tc.qr_tables(split), jc.qr_tables(split)):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


# dense channelizer tolerance: each output sums its window's ~24 (2 Msps)
# products of |x lo| <= 181 in another order than XLA's dot, a few ulps
# of 181 (the dense product's zero terms add exactly)
DENSE_ATOL = 2e-4


@pytest.mark.parametrize("lo_wrap", [True, False])
def test_channelize_matmul_matches_jax(lo_wrap):
    """The dense channelizer with the JAX Channelizer's own device
    constants (_lo_r, _lo_i, _a) carried across, and with its own."""
    rng = np.random.default_rng(4)
    x_r = rng.normal(size=(7, P_IN)).astype(np.float32) * 60
    x_i = rng.normal(size=(7, P_IN)).astype(np.float32) * 60
    offsets = (-275_000.0, 36_500.0, 350_000.0)
    jc = jch.Channelizer(offsets, fs=2_000_000, lo_wrap=lo_wrap,
                         impl="matmul")
    ph = jch.period_phases(offsets, 2_000_000, 500, lo_wrap, 7, 11)
    ph_r, ph_i = np.ascontiguousarray(ph.real), np.ascontiguousarray(ph.imag)
    want = [np.asarray(v) for v in jch._channelize_jit(
        jnp.asarray(x_r), jnp.asarray(x_i), jc._lo_r, jc._lo_i,
        jnp.asarray(ph_r), jnp.asarray(ph_i), jc._a)]
    tables = {"lo_r": np.asarray(jc._lo_r), "lo_i": np.asarray(jc._lo_i),
              "a": np.asarray(jc._a)}
    carried = Channelizer.from_numpy_tables(offsets, tables, impl="matmul",
                                            lo_wrap=lo_wrap, period_cursor=11)
    own = Channelizer(offsets, lo_wrap=lo_wrap, impl="matmul")
    for name, v in tables.items():
        np.testing.assert_array_equal(getattr(own, name).numpy(), v)
    y = carried(_t(x_r), _t(x_i), split=False).numpy()
    assert carried._period_cursor == 18
    yr, yi = channelize_matmul(_t(x_r), _t(x_i), own.lo_r, own.lo_i,
                               _t(ph_r), _t(ph_i), own.a)
    for got in ((y[..., 0], y[..., 1]), (yr.numpy(), yi.numpy())):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=DENSE_ATOL)


@pytest.mark.parametrize("split", [True, False])
def test_channelize_pfb_matches_jax(split):
    """The factorized-DFT filterbank, split-phase and sample-order
    planes.  Tolerance: the residue sums as for CHAN_ATOL, then two DFT
    stages (8 and 10 points at 2 Msps) of unit-modulus factors in
    float32, 18 more products per output: 7.6e-6 at this seed, stated at
    5e-4."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, 6 * P_IN * 2).astype(np.uint8)
    offsets = (-275_000.0, 25_000.0, 350_000.0)
    jc = jch.Channelizer(offsets, fs=2_000_000, lo_wrap=True, impl="pfb")
    if split:
        x_r, x_i = _raw_to_planes_split(jnp.asarray(raw), jnp.float32(127.37),
                                        P_IN)
    else:
        x_r, x_i = _raw_to_planes(jnp.asarray(raw), "cu8",
                                  jnp.float32(127.37), P_IN)
    want = [np.asarray(v) for v in jch._channelize_pfb_jit(
        x_r, x_i, jc.qr_tables(split)[2], jc._pfb_dfa, jc._pfb_tw,
        jc._pfb_dfb, jc._pfb_bins, jc._pfb_a, jc._pfb_b, split=split)]
    tc = Channelizer(offsets, impl="pfb")
    for name in ("dfa", "tw", "dfb", "bins"):
        np.testing.assert_array_equal(getattr(tc, f"pfb_{name}").numpy(),
                                      np.asarray(getattr(jc, f"_pfb_{name}")))
    y = tc(_t(np.asarray(x_r)), _t(np.asarray(x_i)), split=split).numpy()
    a2 = tc.qr_tables(split)[2]
    yr, yi = channelize_pfb(_t(np.asarray(x_r)), _t(np.asarray(x_i)), a2,
                            tc.pfb_dfa, tc.pfb_tw, tc.pfb_dfb, tc.pfb_bins,
                            split)
    for got in ((y[..., 0], y[..., 1]), (yr.numpy(), yi.numpy())):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-4)


def test_channelizer_rejects_what_jax_asserts():
    with pytest.raises(ValueError):
        Channelizer((25_000.0,), impl="fir")
    for impl in ("dft", "pfb"):
        with pytest.raises(ValueError):
            Channelizer((25_000.0,), impl=impl, lo_wrap=False)
    with pytest.raises(ValueError):
        Channelizer((25_000.0,), impl="dft").forward_u8(
            torch.zeros(2 * P_IN, dtype=torch.uint8))


# fused u8 channelizer tolerance (the kernel's plain version against the
# Pallas kernel in interpret mode): the same products, summed by two
# different dense matmuls, as DENSE_ATOL; the period phase is one more
# complex product per output
U8_ATOL = 2e-4


@pytest.mark.parametrize("fs,sdrclk,lo_wrap,b", [
    (2_000_000, 500, True, 64), (2_000_000, 500, False, 64),
    (5_000_000, 1250, True, 32), (6_000_000, 1500, True, 32),
])
def test_channelize_u8_ref_matches_pallas(fs, sdrclk, lo_wrap, b):
    """channelize_u8_ref against channelize_u8_pallas(interpret=True) and
    the golden decimator (atol 5e-4, as tests/test_pallas.py)."""
    rng = np.random.default_rng(6)
    p_in = 4 * sdrclk
    offs = ((25_000.0, -75_000.0, 150_000.0, 36_500.0) if fs == 2_000_000
            else (-1_200_000.0,))
    lo, _ = jch.lo_tables(offs, fs, sdrclk, lo_wrap)
    ph = jch.period_phases(offs, fs, sdrclk, lo_wrap, b, 3)
    a = jch.aggregation_matrix(sdrclk)
    raw = rng.integers(0, 256, (b, p_in, 2)).astype(np.uint8)
    args = [np.ascontiguousarray(v) for v in (lo.real, lo.imag, ph.real,
                                              ph.imag)]
    want = np.asarray(channelize_u8_pallas(
        jnp.asarray(np.ascontiguousarray(raw[:, :, 0])),
        jnp.asarray(np.ascontiguousarray(raw[:, :, 1])),
        *map(jnp.asarray, args), jnp.asarray(a),
        jnp.asarray([np.float32(127.37)]), interpret=True))
    got = chan_u8.channelize_u8_ref(_t(raw.reshape(-1)), *map(_t, args),
                                    _t(a), DC_OFFSET).numpy()
    assert got.shape == want.shape == (len(offs), b, 84, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=U8_ATOL)
    x = (raw[:, :, 0].astype(np.float64) - 127.37
         + 1j * (raw[:, :, 1].astype(np.float64) - 127.37)).reshape(-1)
    for ci, fo in enumerate(offs):
        # the golden decimator starts at period 0: rotate by period 3's
        # phase relative to period 0's
        ref = mix_and_decimate(x, fo, fs, sdrclk, lo_table_wrap=lo_wrap)
        if not lo_wrap:
            ref = ref * np.exp(-2j * np.pi * fo * p_in / fs * 3)
        g = (got[ci, ..., 0] + 1j * got[ci, ..., 1]).reshape(-1)
        np.testing.assert_allclose(g, ref, atol=5e-4)


# ---------------------------------------------------------------- sync

def _jax_sync(y, mode):
    yj = jnp.asarray(y)
    if mode == "fused":
        return sync_scan_pallas(yj, interpret=True)
    return jdemod.sync_scan(jdemod.phase_of(jdemod.polyphase_filter0(yj)))


def _trigger_set(err, fr, k=32):
    t0, _of, _df, valid, _q = jdemod.find_triggers(jnp.asarray(err),
                                                   jnp.asarray(fr), k)
    t0, valid = np.asarray(t0), np.asarray(valid)
    return {(int(c), int(t0[c, k])) for c, k in zip(*np.nonzero(valid))}


def _near_threshold(err, c, t):
    """A trigger decision at (c, t) that the err tolerance can flip: the
    threshold test e1 < 4 or the rise e0 > e1 within tolerance."""
    e0, e1 = err[c, t], err[c, t - 2]
    tol = ERR_TOL["atol"] + ERR_TOL["rtol"] * abs(e1)
    return abs(e1 - 4.0) <= tol or abs(e0 - e1) <= tol


@pytest.mark.parametrize("mode", ["stream", "fused"])
def test_sync_scan_matches_jax(decimated, mode):
    y = decimated
    err_j, fr_j = (np.asarray(v) for v in _jax_sync(y, mode))
    err_t, fr_t = (v.numpy() for v in sync.sync_scan(_t(y), mode))
    assert err_t.shape == err_j.shape == y.shape[:2]
    np.testing.assert_allclose(err_t, err_j, **ERR_TOL)
    np.testing.assert_allclose(fr_t, fr_j, **FR_TOL)
    trig_j, trig_t = _trigger_set(err_j, fr_j), _trigger_set(err_t, fr_t)
    assert len(trig_j) >= 4
    flips = sorted(trig_j ^ trig_t)
    assert all(_near_threshold(err_j, c, t) for c, t in flips), flips


def test_sync_modes_agree(decimated):
    """The two numeric modes compute one metric: Cephes vs libm atan2 and
    one- vs two-pass sums differ only in float32 rounding."""
    e_s, f_s = sync.sync_scan(_t(decimated), "stream")
    e_f, f_f = sync.sync_scan(_t(decimated), "fused")
    np.testing.assert_allclose(e_f.numpy(), e_s.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(f_f.numpy(), f_s.numpy(), rtol=1e-3, atol=1e-4)


def test_cephes_atan2_matches_jax():
    from vdlm2dec_tpu.ops.pallas_sync import _atan2

    rng = np.random.default_rng(2)
    y = rng.normal(size=4096).astype(np.float32) * 50
    x = rng.normal(size=4096).astype(np.float32) * 50
    y[:4] = [0.0, 0.0, 1.0, -1.0]
    x[:4] = [0.0, -1.0, 0.0, 0.0]
    want = np.asarray(_atan2(jnp.asarray(y), jnp.asarray(x)))
    got = sync.cephes_atan2(_t(y), _t(x)).numpy()
    # same float32 operations in the same order: agreement to 1 ulp of
    # pi (XLA may fuse the polynomial differently)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


def test_sync_scan_rejects_bad_input():
    with pytest.raises(ValueError):
        sync.sync_scan(torch.zeros(2, 100, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        sync.sync_scan(torch.zeros(2, 100, 3))
    with pytest.raises(ValueError):
        sync.sync_scan(torch.zeros(2, 100, 2), mode="xla")


# ---------------------------------------------------------------- triggers

def test_find_triggers_matches_jax(decimated):
    err, fr = (np.asarray(v) for v in _jax_sync(decimated, "stream"))
    for k in (4, 32):
        want = [np.asarray(v) for v in
                jdemod.find_triggers(jnp.asarray(err), jnp.asarray(fr), k)]
        got = [v.numpy() for v in demod.find_triggers(_t(err), _t(fr), k)]
        np.testing.assert_array_equal(got[0], want[0])           # t0
        np.testing.assert_array_equal(got[3], want[3])           # valid
        for g, w in zip(got[1:3] + got[4:], want[1:3] + want[4:]):
            # of, df, q: the same float32 expression on identical inputs
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- demod

def test_demod_inline_matches_jax(decimated):
    y = decimated
    err, fr = (np.asarray(v) for v in _jax_sync(y, "stream"))
    t0, of, df, valid, _q = (np.asarray(v) for v in
                             jdemod.find_triggers(jnp.asarray(err),
                                                  jnp.asarray(fr), 8))
    chan = np.repeat(np.arange(y.shape[0]), t0.shape[1]).astype(np.int32)
    args = [chan, t0.reshape(-1).astype(np.int32),
            of.reshape(-1), df.reshape(-1)]
    want = np.asarray(jdemod.demod_candidates_inline(
        jnp.asarray(y), *map(jnp.asarray, args), max_symbols=256))
    got = demod.demod_candidates_inline(_t(y), *map(_t, args),
                                        max_symbols=256).numpy()
    assert got.shape == want.shape == (len(chan), 768)
    # soft bits come from the same 257-entry table; the filter sums in
    # the same order, so only an atan2 ulp at a table-index boundary
    # could move a bit to the neighbouring entry
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- header

def test_header_decode_matches_jax():
    rng = np.random.default_rng(8)
    softs = []
    for _ in range(64):
        length = int(rng.integers(0, 9 * 1992))
        bits = codec.header_encode(length).astype(np.float64)
        softs.append(np.clip(bits * 0.96 + 0.02 + rng.normal(0, 0.2, 25),
                             0.0, 1.0))
    # exact ties: hard 0/1 bits and all-0.5 rows
    softs += [np.full(25, 0.5), np.zeros(25), np.ones(25)]
    soft = np.stack(softs).astype(np.float32)
    want = [np.asarray(v) for v in jhdr.header_decode(jnp.asarray(soft))]
    got = [v.numpy() for v in header.header_decode(_t(soft))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- assembly

def test_assemble_blocks_matches_jax():
    rng = np.random.default_rng(9)
    n = 40
    soft = rng.uniform(size=(n, 8 * jasm.MAX_TX_BYTES)).astype(np.float32)
    nbrow = rng.integers(1, 9, n).astype(np.int32)
    nlbyte = rng.integers(0, 250, n).astype(np.int32)
    nbrow[:3] = [9, 40, 66]          # rejected headers: past the table
    want = [np.asarray(v) for v in jasm.assemble_blocks(
        jnp.asarray(soft), jnp.asarray(nbrow), jnp.asarray(nlbyte))]
    got = [v.numpy() for v in assembly.assemble_blocks(
        _t(soft), _t(nbrow), _t(nlbyte))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- RS

def _rs_case_rows(rng):
    """Rows with 0-4 errors under each erasure class, rows with 8 errors
    (uncorrectable), and all-zero / random rows."""
    rows, classes = [], []
    for trial in range(48):
        data = rng.integers(0, 256, C.RS_K).astype(np.uint8)
        bad = np.concatenate([data, codec.rs_encode_row(data)])
        nerr = int(rng.integers(0, 5)) if trial < 36 else 8
        for p in rng.choice(C.RS_N, nerr, replace=False):
            bad[p] ^= int(rng.integers(1, 256))
        cls = int(rng.integers(0, 3))
        for e in [[], [253, 254], [251, 252, 253, 254]][cls]:
            bad[e] = 0
        rows.append(bad)
        classes.append(cls)
    rows += [np.zeros(C.RS_N, np.uint8),
             rng.integers(0, 256, C.RS_N).astype(np.uint8)]
    classes += [0, 2]
    return np.stack(rows), np.asarray(classes, np.int32)


def test_rs_decode_rows_matches_jax_and_golden():
    rng = np.random.default_rng(6)
    rows, classes = _rs_case_rows(rng)
    want_rows, want_counts = (np.asarray(v) for v in jrs.rs_decode_rows(
        jnp.asarray(rows), jnp.asarray(classes)))
    got_rows, got_counts = (v.numpy() for v in rs_fec.rs_decode_rows(
        _t(rows), _t(classes)))
    assert got_rows.dtype == np.uint8 and got_counts.dtype == np.int32
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(got_counts, want_counts)
    assert (got_counts == -1).sum() >= 6
    for i in range(len(rows)):
        eras = [[], [253, 254], [251, 252, 253, 254]][classes[i]]
        g_out, g_cnt = codec.rs_decode_row(rows[i], eras)
        assert got_counts[i] == g_cnt, i
        np.testing.assert_array_equal(got_rows[i], g_out)
