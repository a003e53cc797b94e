"""Every table the PyTorch port rebuilds in numpy equals its JAX original.

vdlm2dec_tpu_torch/_tables.py copies constants out of jax-importing
modules of vdlm2dec_tpu; these tests pin each copy to the original,
bit for bit, so the two packages cannot drift apart.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from vdlm2dec_tpu import pipeline as jpipe
from vdlm2dec_tpu.ops import assembly as jasm
from vdlm2dec_tpu.ops import channelizer as jch
from vdlm2dec_tpu.ops import demod as jdemod
from vdlm2dec_tpu.ops import header as jhdr
from vdlm2dec_tpu.ops import rs_fec as jrs
from vdlm2dec_tpu.parallel.sharding import HALO_LEFT
from vdlm2dec_tpu_torch import _tables as T

PLANS = [
    ((25_000.0, -75_000.0, 150_000.0), 2_000_000, 500),
    ((-300_000.0, 425_000.0), 2_000_000, 500),
    ((-1_200_000.0, 50_000.0), 5_000_000, 1250),
    ((-1_200_000.0,), 6_000_000, 1500),
]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("plan", PLANS)
def test_dft_qr_tables_equal(plan, split):
    offsets, fs, sdrclk = plan
    w_j, a2_j = jch.dft_qr_tables(offsets, fs, sdrclk, split)
    w_t, a2_t = T.dft_qr_tables(offsets, fs, sdrclk, split)
    assert w_t.dtype == w_j.dtype and a2_t.dtype == a2_j.dtype
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(a2_t, a2_j)


def test_period_and_chan_impl_equal():
    for sdrclk in (500, 1250, 1500):
        assert T.period_for(sdrclk) == jch.period_for(sdrclk)
    cases = [
        ([25_000.0, -75_000.0], 2_000_000, 500, True, "boxcar", False),
        ([25_000.0, -75_000.0], 2_000_000, 500, False, "boxcar", False),
        ([25_000.0, -75_000.0], 2_000_000, 500, True, "fir", False),
        ([25_000.0, -75_000.0], 2_000_000, 500, True, "boxcar", True),
        ([12_500.0], 2_000_000, 500, True, "boxcar", False),
        ([-1_200_000.0], 5_000_000, 1250, True, "boxcar", False),
    ]
    for case in cases:
        assert T.resolve_chan_impl(*case) == jch.resolve_chan_impl(*case)


@pytest.mark.parametrize("sdrclk, fs", [(500, 2_000_000), (1250, 5_000_000),
                                        (1500, 6_000_000)])
def test_fir_aggregation_matrix_equal(sdrclk, fs):
    a_t, pad_t = T.fir_aggregation_matrix(sdrclk, fs)
    a_j, pad_j = jch.fir_aggregation_matrix(sdrclk, fs)
    assert pad_t == pad_j == 265
    assert a_t.dtype == a_j.dtype == np.float32
    assert a_t.shape == (T.period_for(sdrclk)[0] + 2 * 265, 84)
    np.testing.assert_array_equal(a_t, a_j)


def test_demod_tables_equal():
    np.testing.assert_array_equal(T.POLY32, jdemod._POLY32)
    np.testing.assert_array_equal(T.EXT_TAPS, jdemod._EXT_TAPS)
    np.testing.assert_array_equal(T.SW32, jdemod._SW32)
    np.testing.assert_array_equal(T.KS, jdemod._KS)
    assert T.SLOPE_NORM == jdemod._SLOPE_NORM
    # the flat ("xla") demod's exact float32 Gray table, (257, 3)
    np.testing.assert_array_equal(T.GRAY32, jdemod._GRAY32.T)


def test_gray_soft_table_equals_jax_lookup():
    """The port's plain gather must return what the JAX two-part bf16
    one-hot lookup returns, at every one of the 257 indices."""
    got = np.asarray(jdemod._gray_soft(jnp.arange(257, dtype=jnp.int32)))
    assert T.GRAY_SOFT.dtype == np.float32
    np.testing.assert_array_equal(T.GRAY_SOFT, got)


def test_header_and_assembly_tables_equal():
    np.testing.assert_array_equal(T.PERM, jhdr._PERM)
    inv_t, cnt_t = T.inverse_fill_tables()
    inv_j, cnt_j = jasm.inverse_fill_tables()
    assert inv_t.dtype == inv_j.dtype and cnt_t.dtype == cnt_j.dtype
    np.testing.assert_array_equal(inv_t, inv_j)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    assert T.MAX_TX_BYTES == jasm.MAX_TX_BYTES


def test_rs_tables_equal():
    np.testing.assert_array_equal(T.EXPN, jrs._EXPN)
    np.testing.assert_array_equal(T.LOGN, jrs._LOGN)
    np.testing.assert_array_equal(T.gf_mul_table(), jrs._mul_table())
    lam_init, n_eras = T.erasure_init()
    mats = jrs._matrices()
    np.testing.assert_array_equal(lam_init, mats["lam_init"])
    np.testing.assert_array_equal(n_eras, mats["n_eras"])
    pos = T.rs_position_tables()
    np.testing.assert_array_equal(pos["inv"], mats["inv"])


def test_rs_position_tables_match_f2_matrices():
    """The per-position GF constants expand to the JAX decoder's F2
    matrices: bit a of coefficient d times constant [d, q] gives bit b
    of the product at position q."""
    mats = jrs._matrices()
    pos = T.rs_position_tables()
    mul = T.gf_mul_table()

    def expand(consts):                           # (D, 255) -> (8D, 2040)
        d, n = consts.shape
        m = np.zeros((d * 8, n * 8), np.float32)
        for di in range(d):
            for a in range(8):
                v = mul[(1 << a) * 256 + consts[di]]
                m[di * 8 + a] = ((v[:, None] >> np.arange(8)) & 1).reshape(-1)
        return m

    for name, jname in (("chien", "chien"), ("omega", "omega12"),
                        ("den", "den")):
        np.testing.assert_array_equal(expand(pos[name]), mats[jname])
    # the syndrome matrix maps data bit (j, a) to syndrome bit (i, b)
    syn = np.zeros((255 * 8, 48), np.float32)
    for a in range(8):
        v = mul[(1 << a) * 256 + pos["syn"]]      # (6, 255)
        syn[a::8] = ((v.T[:, :, None] >> np.arange(8)) & 1).reshape(255, 48)
    np.testing.assert_array_equal(syn, mats["syn"])


def test_pipeline_constants_equal():
    assert T.RAW_FMT == jpipe.RAW_FMT
    assert T.PACKED_ROW_BYTES == jpipe.PACKED_ROW_BYTES
    assert T.HALO_LEFT == HALO_LEFT


@pytest.mark.parametrize("fs,max_symbols,block_seconds,align", [
    (2_000_000, 5449, 4.0, 1),
    (2_000_000, 512, 0.5, 1),
    (2_000_000, 1376, 2.0, 32),
    (5_000_000, 5449, 0.1, 1),
    (6_000_000, 700, 1.0, 8),
])
def test_stream_geometry_equal(fs, max_symbols, block_seconds, align):
    p_in, p_out = T.period_for(fs // 4000)
    args = (p_in, p_out, fs, max_symbols, block_seconds, align)
    assert T.stream_geometry(*args) == jpipe.stream_geometry(*args)


def test_burst_span_and_unpack_equal():
    rng = np.random.default_rng(11)
    for consumed in (0, 96, 8000, 16320):
        for of in (-3.0, 0.4, 4.5, 7.49, 12.0, 40.0):
            assert (T.burst_span_samples(consumed, of)
                    == jpipe.burst_span_samples(consumed, of))
    buf = rng.integers(0, 256, (12, T.PACKED_ROW_BYTES)).astype(np.uint8)
    meta = buf[:, 2048:].copy().view(np.int32)
    meta[:, 6] = rng.integers(0, 2, 12)
    meta[:, 9:] = rng.integers(0, 50, (12, 3))
    buf[:, 2048:] = meta.view(np.uint8)
    assert T.packed_stats(buf) == jpipe.packed_stats(buf)
    got, want = T.unpack_results(buf), jpipe.unpack_results(buf)
    assert len(got) == len(want) == int(meta[:, 6].sum())
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("plan", PLANS)
def test_dense_channelizer_tables_equal(plan):
    """aggregation_matrix, lo_tables and period_phases (both LO modes, a
    nonzero start period) equal the JAX originals bit for bit."""
    offsets, fs, sdrclk = plan
    a_t = T.aggregation_matrix(sdrclk)
    assert a_t.dtype == np.float32
    np.testing.assert_array_equal(a_t, jch.aggregation_matrix(sdrclk))
    for wrap in (True, False):
        lo_t, tbl_t = T.lo_tables(offsets, fs, sdrclk, wrap)
        lo_j, tbl_j = jch.lo_tables(offsets, fs, sdrclk, wrap)
        assert tbl_t == tbl_j and lo_t.dtype == lo_j.dtype
        np.testing.assert_array_equal(lo_t, lo_j)
        for start in (0, 37):
            ph_t = T.period_phases(offsets, fs, sdrclk, wrap, 12, start)
            ph_j = jch.period_phases(offsets, fs, sdrclk, wrap, 12, start)
            assert ph_t.dtype == ph_j.dtype and ph_t.shape == (len(offsets), 12)
            np.testing.assert_array_equal(ph_t, ph_j)


@pytest.mark.parametrize("plan", PLANS)
def test_pfb_tables_equal(plan):
    offsets, fs, sdrclk = plan
    got, want = T.pfb_tables(offsets, fs, sdrclk), jch.pfb_tables(offsets, fs,
                                                                  sdrclk)
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for n in (80, 200, 240, 97):
        assert T._near_sqrt_factors(n) == jch._near_sqrt_factors(n)
