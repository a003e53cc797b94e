"""The port's "xla" demod, FIR filter, bf16 compute and sample entry
against their JAX twins on the CPU.

Same seeded inputs on both sides; tolerances are stated beside each
comparison with their reason.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as B
from vdlm2dec_tpu.ops import channelizer as jch
from vdlm2dec_tpu.ops import demod as jdemod
from vdlm2dec_tpu.pipeline import _raw_to_planes_split
from vdlm2dec_tpu_torch.ops import demod, sync
from vdlm2dec_tpu_torch.ops.channelizer import (
    Channelizer,
    channelize_dft_qr,
    channelize_fir,
    channelize_matmul,
    channelize_pfb,
    mm_operand,
)
from vdlm2dec_tpu_torch.ops.ingest import raw_to_planes_split

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

P_IN = 2000
FS = 2_000_000
OFFSETS = (-275_000.0, 25_000.0, 350_000.0)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def decimated():
    """(C, T, 2) float32 decimated streams of 0.5 s of dense bursts on
    two channels."""
    wide, freqs, fc, _truth = B.make_capture(FS, 2, 0.5)
    raw = B.to_u8(wide[: len(wide) - len(wide) % P_IN])
    ch = Channelizer([f - fc for f in freqs], fs=FS)
    return ch(*raw_to_planes_split(_t(raw), P_IN), split=True).numpy()


# ---------------------------------------------------------------- "xla" demod

def test_polyphase_filter_matches_jax():
    """The same 17 multiply-adds per branch in the same order: exact.
    Branch 0 is the sync scan's polyphase_filter0."""
    y = np.random.default_rng(0).normal(size=(3, 3000, 2)).astype(
        np.float32) * 30
    want = np.asarray(jdemod.polyphase_filter(jnp.asarray(y)))
    got = demod.polyphase_filter(_t(y)).numpy()
    assert got.shape == want.shape == (3, 4, 3000, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 0],
                                  sync.polyphase_filter0(_t(y)).numpy())


def test_demod_flat_matches_jax(decimated):
    """Flat demod on the full filter tensor: the soft bits are entries of
    the exact float32 Gray table (or 1 minus one), so equal Gray indices
    give them bit for bit; the 1e-5 bound is the inline demod's, for an
    atan2 ulp at an index boundary.  Includes a channel id past the last
    channel and a trigger at the stream's end, which clamp."""
    y = decimated
    c, t, _ = y.shape
    err, fr = jdemod.sync_scan(jdemod.phase_of(
        jdemod.polyphase_filter0(jnp.asarray(y))))
    t0, of, df, _valid, _q = (np.asarray(v) for v in
                              jdemod.find_triggers(err, fr, 8))
    chan = np.repeat(np.arange(c), t0.shape[1]).astype(np.int32)
    args = [np.append(chan, [c, 0]).astype(np.int32),
            np.append(t0.reshape(-1), [100, t - 1]).astype(np.int32),
            np.append(of.reshape(-1), [6.0, 12.0]).astype(np.float32),
            np.append(df.reshape(-1), [0.1, -0.2]).astype(np.float32)]
    f_j = jdemod.polyphase_filter(jnp.asarray(y))
    want = np.asarray(jdemod.demod_candidates_flat(
        jnp.asarray(y), *map(jnp.asarray, args), 256, f_j))
    got = demod.demod_candidates_flat(
        _t(y), *map(_t, args), 256, demod.polyphase_filter(_t(y))).numpy()
    assert got.shape == want.shape == (len(args[0]), 768)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, want)       # Gray indices exact


# ---------------------------------------------------------------- FIR

# FIR tolerance: each output is a 2530-term dot of |a| summing to ~1.1
# with mixed samples up to ~180 (|x| ~ 60 sigma-3 times sqrt 2); the port
# sums it in two pieces, JAX in one: a random-walk bound sqrt(2530) *
# 2^-24 * 1.1 * 180 ~ 6e-4
FIR_ATOL = 6e-4


def _planes(seed, b=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, P_IN)).astype(np.float32) * 60,
            rng.normal(size=(b, P_IN)).astype(np.float32) * 60)


@pytest.mark.parametrize("lo_wrap", [True, False])
def test_channelize_fir_matches_jax(lo_wrap):
    x_r, x_i = _planes(10)
    jc = jch.Channelizer(OFFSETS, fs=FS, lo_wrap=lo_wrap, filter_mode="fir")
    ph = jch.period_phases(OFFSETS, FS, 500, lo_wrap, 6, 5)
    ph_r, ph_i = np.ascontiguousarray(ph.real), np.ascontiguousarray(ph.imag)
    want = [np.asarray(v) for v in jch._channelize_fir_jit(
        jnp.asarray(x_r), jnp.asarray(x_i), jc._lo_r, jc._lo_i,
        jnp.asarray(ph_r), jnp.asarray(ph_i), jc._a_fir, jc._fir_pad)]
    tc = Channelizer(OFFSETS, fs=FS, lo_wrap=lo_wrap, impl="matmul",
                     filter_mode="fir")
    np.testing.assert_array_equal(tc.a_fir.numpy(), np.asarray(jc._a_fir))
    assert tc.fir_pad == jc._fir_pad == 265
    yr, yi = channelize_fir(_t(x_r), _t(x_i), tc.lo_r, tc.lo_i, _t(ph_r),
                            _t(ph_i), tc.a_fir, tc.fir_pad)
    for g, w in zip((yr.numpy(), yi.numpy()), want):
        assert g.shape == w.shape == (3, 6 * 84)
        np.testing.assert_allclose(g, w, rtol=0, atol=FIR_ATOL)
    # and through forward() from the period cursor
    tc._period_cursor = 5
    y = tc(_t(x_r), _t(x_i)).numpy()
    np.testing.assert_allclose(y[..., 0], want[0], rtol=0, atol=FIR_ATOL)
    assert tc._period_cursor == 11


def test_fir_window_edges_see_zeros():
    """One period: the window reaches pad samples past both block edges,
    which are zero (no history across calls), in both implementations."""
    x_r, x_i = _planes(11, b=1)
    jc = jch.Channelizer(OFFSETS[:1], fs=FS, filter_mode="fir")
    tc = Channelizer(OFFSETS[:1], fs=FS, impl="matmul", filter_mode="fir")
    one = np.ones((1, 1), np.float32)
    zero = np.zeros((1, 1), np.float32)
    want = np.asarray(jch._channelize_fir_jit(
        jnp.asarray(x_r), jnp.asarray(x_i), jc._lo_r, jc._lo_i,
        jnp.asarray(one), jnp.asarray(zero), jc._a_fir, jc._fir_pad)[0])
    got = channelize_fir(_t(x_r), _t(x_i), tc.lo_r, tc.lo_i, _t(one),
                         _t(zero), tc.a_fir, tc.fir_pad)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FIR_ATOL)


# ---------------------------------------------------------------- bf16

def _jax_bf16(form, x_r, x_i, compute, lo_wrap=True):
    """JAX's output of one channelizer form on sample-order planes."""
    jc = jch.Channelizer(OFFSETS, fs=FS, lo_wrap=lo_wrap,
                         impl="matmul" if form in ("matmul", "fir") else form,
                         filter_mode="fir" if form == "fir" else "boxcar")
    xj = (jnp.asarray(x_r), jnp.asarray(x_i))
    if form == "dft":
        out = jch._channelize_dft_qr_jit(*xj, *jc.qr_tables(False),
                                         compute=compute)
    elif form == "pfb":
        out = jch._channelize_pfb_jit(
            *xj, jc.qr_tables(False)[2], jc._pfb_dfa, jc._pfb_tw,
            jc._pfb_dfb, jc._pfb_bins, jc._pfb_a, jc._pfb_b,
            compute=compute)
    else:
        ph = jch.period_phases(OFFSETS, FS, 500, lo_wrap, x_r.shape[0], 0)
        ph = (jnp.asarray(np.ascontiguousarray(ph.real)),
              jnp.asarray(np.ascontiguousarray(ph.imag)))
        if form == "fir":
            out = jch._channelize_fir_jit(*xj, jc._lo_r, jc._lo_i, *ph,
                                          jc._a_fir, jc._fir_pad,
                                          compute=compute)
        else:
            out = jch._channelize_jit(*xj, jc._lo_r, jc._lo_i, *ph, jc._a,
                                      compute=compute)
    return np.stack([np.asarray(v) for v in out], axis=-1)


@pytest.mark.parametrize("form", ["matmul", "dft", "pfb", "fir"])
def test_bf16_channelizer_matches_jax(form):
    """compute="bf16" rounds the same operands to bfloat16 as JAX and
    contracts in float32.  Tolerance 1e-2 of max|y|: where the sum order
    differs, an intermediate (z, the twiddled stage) can round to the
    neighbouring bfloat16 (2^-8 relative).  bf16 must differ from f32,
    as tests/test_bf16_mode.py asserts for JAX."""
    x_r, x_i = _planes(12)
    impl = "matmul" if form in ("matmul", "fir") else form
    filt = "fir" if form == "fir" else "boxcar"
    got = {}
    for compute in ("f32", "bf16"):
        tc = Channelizer(OFFSETS, fs=FS, impl=impl, filter_mode=filt,
                         compute=compute)
        got[compute] = tc(_t(x_r), _t(x_i)).numpy()
    want = _jax_bf16(form, x_r, x_i, "bf16")
    scale = np.abs(want).max()
    np.testing.assert_allclose(got["bf16"], want, rtol=0, atol=1e-2 * scale)
    err = np.abs(got["bf16"] - got["f32"]).max() / scale
    assert 0 < err < 0.02
    np.testing.assert_allclose(got["f32"], _jax_bf16(form, x_r, x_i, "f32"),
                               rtol=0, atol=FIR_ATOL)


def test_bf16_split_dft_matches_jax():
    """The split-phase cu8 layout of the dft form under bf16."""
    raw = np.random.default_rng(13).integers(0, 256, 6 * P_IN * 2).astype(
        np.uint8)
    jc = jch.Channelizer(OFFSETS, fs=FS, impl="dft")
    x_r, x_i = _raw_to_planes_split(jnp.asarray(raw), jnp.float32(127.37),
                                    P_IN)
    want = np.stack([np.asarray(v) for v in jch._channelize_dft_qr_jit(
        x_r, x_i, *jc.qr_tables(True), split=True, compute="bf16")], -1)
    tc = Channelizer(OFFSETS, fs=FS, impl="dft", compute="bf16")
    w_r, w_i, a2 = tc.qr_tables(True)
    yr, yi = channelize_dft_qr(_t(np.asarray(x_r)), _t(np.asarray(x_i)),
                               w_r, w_i, a2, True, "bf16")
    got = np.stack([yr.numpy(), yi.numpy()], -1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def test_mm_operand_rounds_to_bfloat16():
    x = torch.tensor([1.0, 1.0 + 2 ** -9, 1.0 + 3 * 2 ** -9, 1 / 3])
    got = mm_operand(x, "bf16")
    want = jnp.asarray(x.numpy()).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert mm_operand(x, "f32") is x


def test_bf16_forms_take_the_compute_argument():
    """The plane functions default to f32, and bf16 changes them."""
    x_r, x_i = (_t(v) for v in _planes(14))
    tc = Channelizer(OFFSETS, fs=FS, impl="matmul")
    ones = torch.ones(3, 6)
    zeros = torch.zeros(3, 6)
    f32 = channelize_matmul(x_r, x_i, tc.lo_r, tc.lo_i, ones, zeros, tc.a)
    bf = channelize_matmul(x_r, x_i, tc.lo_r, tc.lo_i, ones, zeros, tc.a,
                           "bf16")
    assert not torch.equal(f32[0], bf[0])
    tp = Channelizer(OFFSETS, fs=FS, impl="pfb")
    a2 = tp.qr_tables(False)[2]
    args = (x_r, x_i, a2, tp.pfb_dfa, tp.pfb_tw, tp.pfb_dfb, tp.pfb_bins,
            False)
    assert not torch.equal(channelize_pfb(*args)[0],
                           channelize_pfb(*args, "bf16")[0])


# ---------------------------------------------------------------- sample entry

# sample entry tolerance: the plane forms' own (dense 2e-4, FIR 6e-4,
# pfb 5e-4), at |x| ~ 60
ENTRY_ATOL = {"matmul": 2e-4, "dft": 2e-4, "pfb": 5e-4, "fir": FIR_ATOL}


@pytest.mark.parametrize("kind", ["complex64", "planes", "real_input",
                                  "torch_complex"])
@pytest.mark.parametrize("form", ["matmul", "dft", "pfb", "fir"])
def test_sample_entry_matches_jax(form, kind):
    """Channelizer.channelize against the JAX Channelizer's __call__ on
    complex64 samples, (T, 2) planes, real_input (x_i = 0) and a torch
    complex tensor; two consecutive blocks move the period cursor, then
    an explicit period0 leaves it."""
    rng = np.random.default_rng(15)
    x = ((rng.normal(size=5 * P_IN) + 1j * rng.normal(size=5 * P_IN))
         * 60).astype(np.complex64)
    impl = "matmul" if form == "fir" else form
    filt = "fir" if form == "fir" else "boxcar"
    real = kind == "real_input"
    lo_wrap = form != "matmul"             # the continuous LO on matmul
    jc = jch.Channelizer(OFFSETS, fs=FS, lo_wrap=lo_wrap, real_input=real,
                         filter_mode=filt, impl=impl)
    tc = Channelizer(OFFSETS, fs=FS, lo_wrap=lo_wrap, real_input=real,
                     filter_mode=filt, impl=impl)
    if kind == "planes":
        arg = np.stack([x.real, x.imag], axis=-1)
    elif kind == "torch_complex":
        arg = _t(x)
    else:
        arg = x
    jarg = np.asarray(arg) if kind == "torch_complex" else arg
    for period0 in (None, None, 3):
        want = np.asarray(jc(jarg, period0=period0))
        got = tc.channelize(arg, period0=period0).numpy()
        assert got.shape == want.shape == (3, 5 * 84, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=ENTRY_ATOL[form])
    assert tc._period_cursor == jc._period_cursor == 10
    with pytest.raises(ValueError):
        tc.channelize(x[:P_IN + 1])


def test_channelizer_refuses_fir_on_residue_forms():
    for impl in ("dft", "pfb"):
        with pytest.raises(ValueError):
            Channelizer(OFFSETS, impl=impl, filter_mode="fir")
    with pytest.raises(ValueError):
        Channelizer(OFFSETS, impl="matmul", compute="f16")
    with pytest.raises(ValueError):
        Channelizer(OFFSETS, impl="matmul", filter_mode="fir").forward_u8(
            torch.zeros(2 * P_IN, dtype=torch.uint8))
