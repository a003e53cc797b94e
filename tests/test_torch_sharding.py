"""The PyTorch port's (chan, time) mesh against the JAX package's, on the CPU.

The JAX side runs on the virtual 8-device CPU mesh of tests/conftest.py;
the port's meshes hold the CPU eight (or four) times.  Same inputs, made
from a numpy seed, through both: globalize_t0, the halo exchange (also a
shard shorter than a halo), channelize_shard (wrapped and continuous LO,
nonzero period0; 1e-4 of max|y|), and the packed rows of ShardedDecoder
and ShardedWidebandDecoder on the meshes of tests/test_sharding.py, held
as tests/test_torch_pipeline.py holds packed rows.  Then the port's own
counterparts of tests/test_sharding.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from vdlm2dec_tpu import modulator as mod
from vdlm2dec_tpu.ops.channelizer import (aggregation_matrix, lo_tables,
                                          period_for)
from vdlm2dec_tpu.parallel import sharding as jsh
from vdlm2dec_tpu_torch import pipeline as tpipe
from vdlm2dec_tpu_torch._tables import HALO_LEFT, PipelineConfig
from vdlm2dec_tpu_torch.parallel import sharding as tsh

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

INT_WORDS = [0, 1, 2, 3, 4, 5, 6]          # chan, t0, length, .., live


def _cpu_mesh(n_chan, n_time):
    return tsh.make_mesh(n_chan, n_time, devices=["cpu"] * (n_chan * n_time))


def _sig_with_bursts(rng, starts, total, contents):
    sig = np.zeros(total, dtype=np.complex128)
    for st, c in zip(starts, contents):
        sig += mod.synthesize_baseband(mod.make_burst([c]), start=st,
                                       total=total)
    return mod.awgn(sig, 15.0, rng)


@pytest.fixture(scope="module")
def seam_streams():
    """Two channels of 4 x 8400 samples: one burst inside the first
    quarter, one straddling the middle (a shard boundary of every mesh
    used here), a third late on channel 1 only."""
    rng = np.random.default_rng(0)
    t_total = 4 * 8400
    contents = [rng.integers(0, 256, n).astype(np.uint8) for n in (30, 40, 25)]
    sig = _sig_with_bursts(rng, [2000, 16500], t_total, contents[:2])
    late = _sig_with_bursts(rng, [27_000], t_total, contents[2:])
    return np.stack([sig, sig + late]).astype(np.complex64)


def _frames(bursts):
    return sorted((b.channel, b.t0, tuple(f.tolist()))
                  for b in bursts for f in b.frames)


def _assert_packed_match(jb, tb, float_tol=1e-5):
    """Live rows identical (the float words of/df to float_tol: 1e-5 on
    the same decimated input; 1e-3 behind the dense channelizer, whose
    sums the two backends order differently and whose timing offset is a
    parabola through three values of the sync metric); a slot that is
    live on neither side may differ, as a junk trigger whose threshold
    test sits within the sync tolerance can flip.  The block counters
    ride in each shard's first row: their sums agree up to such slots."""
    assert jb.shape == tb.shape
    jm = jb[:, 2048:].copy().view(np.int32)
    tm = tb[:, 2048:].copy().view(np.int32)
    jkeys = {(int(r[0]), int(r[1])): i for i, r in enumerate(jm) if r[6]}
    tkeys = {(int(r[0]), int(r[1])): i for i, r in enumerate(tm) if r[6]}
    assert jkeys.keys() == tkeys.keys()
    assert len(jkeys) > 0
    for key, i in jkeys.items():
        k = tkeys[key]
        assert k == i                      # the same slot of the same shard
        np.testing.assert_array_equal(tb[k, :2048], jb[i, :2048])
        np.testing.assert_array_equal(tm[k, INT_WORDS], jm[i, INT_WORDS])
        np.testing.assert_allclose(tm[k, 7:9].view(np.float32),
                                   jm[i, 7:9].view(np.float32),
                                   rtol=float_tol, atol=float_tol)
    n_diff = int((jm[:, :2] != tm[:, :2]).any(axis=1).sum())
    assert np.abs(jm[:, 9:].sum(axis=0) - tm[:, 9:].sum(axis=0)).max() <= n_diff


# ---------------------------------------------------------------- pieces

def test_globalize_t0_matches_jax():
    rng = np.random.default_rng(1)
    buf = rng.integers(0, 256, (24, 2096)).astype(np.uint8)
    for off in (0, 4200, 7 * 8400, -160):
        want = np.asarray(jsh.globalize_t0(jnp.asarray(buf), jnp.int32(off)))
        got = tsh.globalize_t0(torch.from_numpy(buf), off).numpy()
        np.testing.assert_array_equal(got, want)
    t0 = got[:, 2052:2056].copy().view(np.int32)[:, 0]
    assert (t0 == buf[:, 2052:2056].copy().view(np.int32)[:, 0] - 160).all()


@pytest.mark.parametrize("t_local,left,right", [
    (300, 160, 200),          # both halos inside the neighbour
    (100, 160, 248),          # a shard shorter than either halo
    (64, 0, 32),              # no left halo
])
def test_halo_exchange_matches_jax(t_local, left, right):
    rng = np.random.default_rng(2)
    n_chan, n_time = 2, 4
    y = rng.normal(size=(4, n_time * t_local, 2)).astype(np.float32)
    mesh = jsh.make_mesh(n_chan, n_time)
    spec = P("chan", "time", None)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda v: jsh._halo_exchange(v, left, right, "time"),
        mesh=mesh, in_specs=(spec,), out_specs=spec))(jnp.asarray(y)))
    tmesh = _cpu_mesh(n_chan, n_time)
    rows = [tsh.halo_exchange(row, left, right)
            for row in tsh.shard_channels(tmesh, y)]
    got = torch.cat([torch.cat(row, dim=1) for row in rows], dim=0).numpy()
    np.testing.assert_array_equal(got, want)
    # the stream's two ends see zeros
    assert rows[0][0].shape[1] == (min(left, t_local) + t_local
                                   + min(right, t_local))
    assert not got[:, :min(left, t_local)].any()


@pytest.mark.parametrize("lo_wrap,period0", [(True, 0), (True, 1234),
                                             (False, 0), (False, 98_765)])
def test_channelize_shard_matches_jax(lo_wrap, period0):
    """The dense shard channelizer at a nonzero period0: the period index
    and the angle are float32 on both sides."""
    rng = np.random.default_rng(3)
    fs, sdrclk = 2_000_000, 500
    p_in, _ = period_for(sdrclk)
    n_chan, n_time = 2, 4
    offs = (25_000.0, 50_000.0, -25_000.0, -61_300.0)
    x = rng.normal(scale=40.0, size=(n_time * 6 * p_in, 2)).astype(np.float32)
    lo, _ = lo_tables(offs, fs, sdrclk, lo_wrap)
    ang = (np.zeros(len(offs)) if lo_wrap
           else 2.0 * np.pi * np.asarray(offs) * (p_in / fs))
    mesh = jsh.make_mesh(n_chan, n_time)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda xs, lr, li, a, an: jsh.channelize_shard(
            xs, lr, li, a, an, p_in, jnp.float32(period0)),
        mesh=mesh,
        in_specs=(P("time", None), P("chan", None), P("chan", None),
                  P(None, None), P("chan")),
        out_specs=P("chan", "time", None)))(
            jnp.asarray(x), jnp.asarray(lo.real), jnp.asarray(lo.imag),
            jnp.asarray(aggregation_matrix(sdrclk)),
            jnp.asarray(ang, dtype=jnp.float32)))
    tmesh = _cpu_mesh(n_chan, n_time)
    consts = tsh.raw_constants(tmesh, offs, fs, sdrclk, lo_wrap)
    shards = tsh.shard_raw(tmesh, x, p_in)
    got = torch.cat([
        torch.cat([tsh.channelize_shard(xs, *consts[ci][tj], p_in, period0, tj)
                   for tj, xs in enumerate(row)], dim=1)
        for ci, row in enumerate(shards)], dim=0).numpy()
    assert got.shape == want.shape == (4, n_time * 6 * 84, 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_make_mesh_layout_and_too_few_devices():
    mesh = tsh.make_mesh(2, 3, devices=["cpu"] * 7)
    assert mesh.shape == (2, 3) and mesh.axis_names == ("chan", "time")
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    with pytest.raises(ValueError, match="need 8 devices, have 3"):
        tsh.make_mesh(2, 4, devices=["cpu"] * 3)
    # no device list: the visible CUDA cards, never the CPU
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {n + 1} devices, have {n}"):
        tsh.make_mesh(1, n + 1)
    # chan-major rows, and the multi-process grid's time-major columns
    names = [f"cuda:{i}" for i in range(6)]
    assert [[d.index for d in row] for row in tsh.grid(names, 2, 3)] == \
        [[0, 1, 2], [3, 4, 5]]
    assert [[d.index for d in row]
            for row in tsh.grid(names, 2, 3, time_major=True)] == \
        [[0, 2, 4], [1, 3, 5]]
    assert tsh.burst_window(512) == jsh.burst_window(512)
    assert tsh.HALO_LEFT == jsh.HALO_LEFT == HALO_LEFT


def test_shards_must_divide():
    with pytest.raises(ValueError):
        tsh.shard_channels(_cpu_mesh(2, 4), np.zeros((3, 800), np.complex64))
    with pytest.raises(ValueError):
        tsh.shard_channels(_cpu_mesh(2, 4), np.zeros((2, 801), np.complex64))
    with pytest.raises(ValueError):
        tsh.shard_raw(_cpu_mesh(1, 4), np.zeros(4 * 2000 + 4, np.complex64),
                      2000)
    with pytest.raises(ValueError):
        tsh.raw_constants(_cpu_mesh(2, 2), (0.0, 25e3, 50e3), 2_000_000, 500,
                          True)


# ---------------------------------------------------------------- packed rows

@pytest.mark.parametrize("n_chan,n_time", [(2, 4), (1, 8), (2, 2)])
def test_sharded_decoder_packed_rows_match_jax(seam_streams, n_chan, n_time):
    kw = dict(max_candidates=4, max_symbols=512)
    got, want = [], []
    jc = jsh.ShardedDecoder(jsh.make_mesh(n_chan, n_time), **kw).decode(
        seam_streams, observer=want.append)
    tc = tsh.ShardedDecoder(_cpu_mesh(n_chan, n_time), **kw).decode(
        seam_streams, observer=got.append)
    assert got[0].shape == (n_time * 2 * 4, 2096)    # 4 slots a channel
    _assert_packed_match(want[0], got[0])
    assert sorted((c["chan"], c["t0"]) for c in tc) == \
        sorted((c["chan"], c["t0"]) for c in jc)
    # the seam burst on both channels, the late one on channel 1 only
    assert sum(16_500 < c["t0"] < 16_800 for c in tc) == 2
    assert [c["chan"] for c in tc if c["t0"] > 27_000] == [1]


@pytest.fixture(scope="module")
def wideband_burst():
    """tests/test_sharding.py's wideband stimulus: one burst on channel 1
    of four, 4 x 25 periods of 2000 samples."""
    rng = np.random.default_rng(2)
    fs, sdrclk = 2_000_000, 500
    t_raw = 4 * 25 * 4 * sdrclk
    offs = (25_000.0, 50_000.0, -25_000.0, -50_000.0)
    content = rng.integers(0, 256, 20).astype(np.uint8)
    bb = mod.synthesize_baseband(mod.make_burst([content]), start=2500,
                                 total=t_raw * 21 // sdrclk)
    wide = mod.upsample_to_wideband(bb, fs, offs[1], total=t_raw)
    return mod.awgn(wide * 20.0, 25.0, rng).astype(np.complex64), offs


@pytest.mark.parametrize("lo_wrap", [True, False])
def test_sharded_wideband_packed_rows_match_jax(wideband_burst, lo_wrap):
    wide, offs = wideband_burst
    kw = dict(f_offsets=offs, fs=2_000_000, sdrclk=500, lo_wrap=lo_wrap,
              max_candidates=4, max_symbols=512)
    got, want = [], []
    jsh.ShardedWidebandDecoder(jsh.make_mesh(2, 2), **kw).decode(
        wide, observer=want.append)
    cands = tsh.ShardedWidebandDecoder(_cpu_mesh(2, 2), **kw).decode(
        wide, observer=got.append)
    _assert_packed_match(want[0], got[0], float_tol=1e-3)
    good = [c for c in cands if c["chan"] == 1]
    assert good and abs(good[0]["t0"] - 2636) < 20


# ------------------------------------- counterparts of tests/test_sharding.py

def test_sharded_matches_unsharded_with_seam_burst(seam_streams):
    kw = dict(freqs_hz=[136_975_000.0, 136_925_000.0], fc_hz=136_900_000.0,
              max_symbols=512, max_candidates=4)
    ref = tpipe.Pipeline(PipelineConfig(**kw), device="cpu").decode_channels(
        seam_streams)
    assert len(_frames(ref)) == 5         # 2 bursts x 2 channels + the late one
    pipe = tpipe.Pipeline(PipelineConfig(**kw, mesh=_cpu_mesh(2, 4)),
                          device="cpu")
    seen = []
    pipe.observe_packed = lambda buf, s=0.0: seen.append(buf.shape)
    assert _frames(pipe.decode_channels(seam_streams)) == _frames(ref)
    assert seen == [(8 * 4, 2096)]        # one fetch, through the observer
    # torch planes on the pipeline's device take the same road
    planes = torch.from_numpy(tpipe.pack_complex(seam_streams))
    assert _frames(pipe.decode_channels(planes)) == _frames(ref)


def test_sharded_time_only_mesh():
    rng = np.random.default_rng(1)
    t_total = 8 * 4200
    content = rng.integers(0, 256, 25).astype(np.uint8)
    sig = _sig_with_bursts(rng, [9000], t_total, [content])
    dec = tsh.ShardedDecoder(_cpu_mesh(1, 8), max_candidates=2,
                             max_symbols=512)
    cands = dec.decode(sig[None, :].astype(np.complex64))
    assert len(cands) >= 1
    # the owning shard is shard 2 (9000+sync in [8400, 12600))
    assert any(8400 <= c["t0"] < 12600 for c in cands)


def test_sharded_wideband_packed_decodes_burst(wideband_burst):
    wide, offs = wideband_burst
    dec = tsh.ShardedWidebandDecoder(
        _cpu_mesh(2, 2), f_offsets=offs, fs=2_000_000, sdrclk=500,
        lo_wrap=True, max_candidates=4, max_symbols=512)
    # planes in, as well as complex samples
    for x in (wide, tpipe.pack_complex(wide)):
        cands = dec.decode(x)
        assert any(c["chan"] == 1 for c in cands)
        good = [c for c in cands if c["chan"] == 1][0]
        assert abs(good["t0"] - 2636) < 20


def test_decoder_defaults_are_the_jax_defaults():
    import dataclasses

    for name in ("ShardedDecoder", "ShardedWidebandDecoder"):
        jf = {f.name: f.default for f in dataclasses.fields(getattr(jsh, name))}
        tf = {f.name: f.default for f in dataclasses.fields(getattr(tsh, name))}
        del jf["mesh"], tf["mesh"]
        assert jf == tf
