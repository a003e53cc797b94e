"""The PyTorch port's decode slice against the JAX Pipeline, on the CPU.

Same capture, same PipelineConfig, both sync modes and every route of the
fused streaming path (channelizers dft / matmul / pfb / use_pallas, the
four capture formats): the packed rows of every live decode slot (meta
word 6 = 1) must agree byte for byte, apart from the float of/df words,
and the decoded frames must equal the JAX frames and the stimulus truth.
Where JAX reaches its Pallas ingest kernel it runs in interpret mode.
Also pins the q-ranked slot compaction under slot pressure on both
backends.
"""
import functools
import threading
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as B
from vdlm2dec_tpu import pipeline as jpipe
from vdlm2dec_tpu.ops import pallas_channelizer as jpallas
from vdlm2dec_tpu_torch import pipeline as tpipe
from vdlm2dec_tpu_torch._tables import PipelineConfig, unpack_results

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

FS = 2_000_000
INT_WORDS = [0, 1, 2, 3, 4, 5, 6]          # chan, t0, length, .., live


@pytest.fixture(scope="module")
def capture():
    wide, freqs, fc, truth = B.make_capture(FS, 2, 1.0)
    wide = wide[: len(wide) - len(wide) % 2000]
    return B.to_u8(wide), freqs, fc, truth


def _cfg_kw(freqs, fc, sync_impl, **kw):
    return dict(freqs_hz=[float(f) for f in freqs], fs=FS, fc_hz=float(fc),
                max_candidates=16, max_symbols=512, max_out=48,
                sync_impl=sync_impl, **kw)


def _pipes(freqs, fc, sync_impl, **kw):
    kw = _cfg_kw(freqs, fc, sync_impl, **kw)
    return (jpipe.Pipeline(jpipe.PipelineConfig(**kw)),
            tpipe.Pipeline(PipelineConfig(**kw), device="cpu"))


def _frames(bursts):
    return sorted((b.channel, bytes(bytearray(f[1:-3])))
                  for b in bursts for f in b.frames)


def _assert_packed_match(jb, tb):
    """Live rows identical (float words of/df to 1e-5: the metric they
    come from agrees to the sync tolerance); a slot that is live on
    neither side may differ, as a junk trigger whose threshold test sits
    within the sync tolerance can flip."""
    assert jb.shape == tb.shape
    jm = jb[:, 2048:].copy().view(np.int32)
    tm = tb[:, 2048:].copy().view(np.int32)
    jl, tl = jm[:, 6] == 1, tm[:, 6] == 1
    jkeys = {(int(r[0]), int(r[1])): i for i, r in enumerate(jm) if r[6]}
    tkeys = {(int(r[0]), int(r[1])): i for i, r in enumerate(tm) if r[6]}
    assert jkeys.keys() == tkeys.keys()
    assert jl.sum() > 0
    for key, i in jkeys.items():
        k = tkeys[key]
        np.testing.assert_array_equal(tb[k, :2048], jb[i, :2048])
        np.testing.assert_array_equal(tm[k, INT_WORDS], jm[i, INT_WORDS])
        np.testing.assert_allclose(tm[k, 7:9].view(np.float32),
                                   jm[i, 7:9].view(np.float32),
                                   rtol=1e-5, atol=1e-5)
    # block counters: slots that differ can only be junk triggers
    n_diff = int((jm[:, :2] != tm[:, :2]).any(axis=1).sum())
    assert np.abs(jm[0, 9:] - tm[0, 9:]).max() <= n_diff


@pytest.mark.parametrize("sync_impl", ["stream", "fused"])
def test_decode_wideband_u8_matches_jax(capture, sync_impl):
    raw, freqs, fc, truth = capture
    jp, tp = _pipes(freqs, fc, sync_impl)
    jb = np.asarray(jpipe._dispatch_fused(jp, raw, "cu8", 0, 0))
    tb = tp.dispatch_fused(raw, "cu8", 0, 0).numpy()
    _assert_packed_match(jb, tb)
    assert tp.channelizer._period_cursor == len(raw) // 2 // 2000
    # the public entry point on a fresh pipeline: the same candidates
    _, tp2 = _pipes(freqs, fc, sync_impl)
    cands = tp2.decode_wideband_u8(raw)
    want_cands = unpack_results(tb)
    scalars = ("chan", "t0", "length", "nbrow", "nlbyte", "consumed",
               "of", "df")
    assert [[c[k] for k in scalars] for c in cands] == \
        [[c[k] for k in scalars] for c in want_cands]
    for c, w in zip(cands, want_cands):
        np.testing.assert_array_equal(c["block"], w["block"])
        np.testing.assert_array_equal(c["rs_counts"], w["rs_counts"])
    got = tp2._finish(cands, 0)
    want = jp._finish(jpipe.unpack_results(jb), 0)
    assert _frames(got) == _frames(want) == sorted((c, b) for c, b, *_ in truth)


def _assert_bursts_match(got, want, truth):
    """Block for block, field for field, and the frames equal the truth."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.channel, g.t0, g.length_bits, g.nbrow, g.nlbyte,
                g.rs_counts) == (w.channel, w.t0, w.length_bits, w.nbrow,
                                 w.nlbyte, w.rs_counts)
        np.testing.assert_array_equal(g.block, w.block)
        assert g.ppm == pytest.approx(w.ppm, rel=1e-4, abs=1e-3)
    assert _frames(got) == _frames(want) == sorted((c, b) for c, b, *_ in truth)


@pytest.mark.parametrize("sync_impl", ["stream", "fused"])
def test_stream_wideband_u8_matches_jax(capture, sync_impl):
    raw, freqs, fc, truth = capture
    jp, tp = _pipes(freqs, fc, sync_impl)
    want = [b for bs in jp.stream_wideband_u8(raw, block_seconds=0.25)
            for b in bs]
    got = [b for bs in tp.stream_wideband_u8(raw, block_seconds=0.25)
           for b in bs]
    _assert_bursts_match(got, want, truth)


@pytest.fixture(scope="module")
def small_captures():
    """One 0.5 s, 2-channel stimulus in every capture format: cu8, cs16
    (round(wide * 256) as tools/drive_formats.py), cf32 at 2 Msps, and an
    airspy f32real capture 2 Re{wide} at 6 Msps, whose offsets (+250,
    +300 kHz from F0) put each conjugate image outside every channel."""
    wide, freqs, fc, truth = B.make_capture(FS, 2, 0.5)
    wide = wide[: len(wide) - len(wide) % 2000]
    inter = np.empty(2 * len(wide), np.float32)
    inter[0::2], inter[1::2] = wide.real, wide.imag
    caps = {
        "cu8": B.to_u8(wide),
        "cs16": np.clip(np.round(inter * 256), -32768, 32767).astype(np.int16),
        "cf32": inter,
    }
    plan = (freqs, fc, truth)
    wide6, freqs6, fc6, truth6 = B.make_capture(6_000_000, 2, 0.5)
    real = (2 * wide6.real).astype(np.float32)
    caps["f32real"] = real[: len(real) - len(real) % 6000]
    return caps, plan, (freqs6, fc6, truth6)


ROUTES = {
    "pallas": ("cu8", dict(use_pallas=True)),
    "matmul": ("cu8", dict(chan_impl="matmul")),
    "pfb": ("cu8", dict(chan_impl="pfb")),
    "cs16": ("cs16", dict()),
    "cf32": ("cf32", dict(chan_impl="matmul")),
    "f32real": ("f32real", dict(real_input=True, fs=6_000_000)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_stream_wideband_u8_route_matches_jax(small_captures, route,
                                              monkeypatch):
    """Each further route of the fused streaming path against JAX's:
    use_pallas (JAX's Pallas kernel in interpret mode), the matmul and
    pfb channelizers, cs16 (dft, sample-order planes), cf32 (matmul) and
    an airspy f32real capture at 6 Msps (real_input: F0 = fc + fs/4)."""
    caps, plan2, plan6 = small_captures
    fmt, extra = ROUTES[route]
    freqs, fc, truth = plan6 if fmt == "f32real" else plan2
    if extra.get("real_input"):
        fc = fc - extra["fs"] // 4           # so that F0 is the capture's fc
    if extra.get("use_pallas"):
        monkeypatch.setattr(jpallas, "channelize_u8_pallas", functools.partial(
            jpallas.channelize_u8_pallas, interpret=True))
    kw = {**_cfg_kw(freqs, fc, "stream"), **extra}
    jp = jpipe.Pipeline(jpipe.PipelineConfig(**kw))
    tp = tpipe.Pipeline(PipelineConfig(**kw), device="cpu")
    assert tp.channelizer.impl == jp.channelizer.impl
    want = [b for bs in jp.stream_wideband_u8(caps[fmt], block_seconds=0.25,
                                              fmt=fmt) for b in bs]
    got = [b for bs in tp.stream_wideband_u8(caps[fmt], block_seconds=0.25,
                                             fmt=fmt) for b in bs]
    _assert_bursts_match(got, want, truth)


def test_decode_wideband_u8_lo_wrap_false_matches_jax(small_captures):
    """The continuous LO (matmul route): two consecutive blocks through
    decode_wideband_u8, the second continuing the LO phase from the
    period cursor, give JAX's packed rows."""
    caps, (freqs, fc, truth), _ = small_captures
    jp, tp = _pipes(freqs, fc, "stream", lo_wrap=False)
    assert tp.cfg.chan_impl == jp.cfg.chan_impl == "matmul"
    raw = caps["cu8"]
    half = len(raw) // 2 - (len(raw) // 2) % 4000
    for part in (raw[:half], raw[half:]):
        jb = np.asarray(jpipe._dispatch_fused(jp, part, "cu8", 0, 0))
        tb = tp.dispatch_fused(part, "cu8", 0, 0).numpy()
        _assert_packed_match(jb, tb)
        assert tp.channelizer._period_cursor == jp.channelizer._period_cursor
    cands = tpipe.Pipeline(tp.cfg, device="cpu").decode_wideband_u8(raw)
    got = tp._finish(cands, 0)
    assert _frames(got) == sorted((c, b) for c, b, *_ in truth)


def test_abandoned_stream_stops_its_fetch_thread(capture):
    """Closing the generator after its first block joins the
    PipelinedDecoder's fetch thread: no thread outlives the stream."""
    raw, freqs, fc, _truth = capture
    _, tp = _pipes(freqs, fc, "stream")
    before = set(threading.enumerate())
    gen = tp.stream_wideband_u8(raw, block_seconds=0.25)
    next(gen)
    assert len(set(threading.enumerate()) - before) == 1
    gen.close()
    assert set(threading.enumerate()) - before == set()


def _cand_keys(cands):
    """A block's candidates in the order yielded: integer words and the
    burst block (the float words of / df are held in _assert_packed_match)."""
    return [(c["chan"], c["t0"], c["length"], c["nbrow"], c["nlbyte"],
             c["consumed"], c["block"].tobytes()) for c in cands]


def test_pipelined_decoder_workers_match_one_worker_and_jax(capture):
    """The port's PipelinedDecoder, one fetch thread, yields block by
    block in submission order the candidates of the JAX package's
    PipelinedDecoder with one fetch thread and with two; close() joins
    its thread, and again is a no-op."""
    raw, freqs, fc, _truth = capture
    jp, tp = _pipes(freqs, fc, "stream")
    blocks = np.split(raw, 4)                  # 250 periods each
    before = set(threading.enumerate())

    def run(pd, n_threads):
        out = []
        try:
            for blk in blocks:
                out += [_cand_keys(c) for c in pd.submit(blk)]
            assert len(set(threading.enumerate()) - before) == n_threads
            out += [_cand_keys(c) for c in pd.drain()]
        finally:
            pd.close()
        pd.close()
        assert set(threading.enumerate()) - before == set()
        return out

    one = tpipe.PipelinedDecoder(tp)
    got = run(one, 1)
    assert not one._thread.is_alive()
    assert len(got) == len(blocks) and any(got)
    assert run(jpipe.PipelinedDecoder(jp), 1) == got
    assert run(jpipe.PipelinedDecoder(jp, workers=2), 2) == got


def test_pipelined_decoder_many_workers_under_thread_switching(capture):
    """The fetch thread beside the consumer, switching every 10 us: every
    block comes back once, in order, with the candidates of
    decode_wideband_u8 run block by block, and the stage counters that
    the fetch thread folds in under the pipeline's lock lose no update."""
    import sys

    from vdlm2dec_tpu_torch.metrics import PipelineMetrics

    raw, freqs, fc, _truth = capture
    _, tp = _pipes(freqs, fc, "stream")
    blocks = np.split(raw, 20)                 # 50 periods each
    tp.metrics = PipelineMetrics()
    want = [_cand_keys(tp.decode_wideband_u8(b)) for b in blocks]
    want_counts = (tp.metrics.sync_candidates,
                   tp.metrics.bursts_rejected_header)
    tp.metrics = PipelineMetrics()
    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-5)
        pd = tpipe.PipelinedDecoder(tp)
        try:
            got = [_cand_keys(c) for b in blocks for c in pd.submit(b)]
            got += [_cand_keys(c) for c in pd.drain()]
        finally:
            pd.close()
    finally:
        sys.setswitchinterval(interval)
    assert not pd._thread.is_alive()
    assert len(got) == len(blocks) and got == want and any(got)
    assert (tp.metrics.sync_candidates,
            tp.metrics.bursts_rejected_header) == want_counts
    assert want_counts[0] > 0


def test_unported_configs_raise():
    kw = dict(freqs_hz=[136_975_000.0], fc_hz=136_900_000.0)
    # what the JAX package refuses by assertion
    for extra in (dict(use_pallas=True, chan_impl="dft"),
                  dict(use_pallas=True, chan_impl="pfb"),
                  dict(chan_impl="pfb", lo_wrap=False),
                  dict(chan_impl="dft", filter_mode="fir"),
                  dict(compute="f16"), dict(sync_impl="pallas")):
        with pytest.raises(ValueError):
            tpipe.Pipeline(PipelineConfig(**kw, **extra), device="cpu")
    for extra in (dict(lo_wrap=False), dict(filter_mode="fir")):
        with pytest.raises(ValueError):
            next(tpipe.Pipeline(PipelineConfig(**kw, **extra),
                                device="cpu").stream_wideband_u8(
                np.zeros(8000, np.uint8)))
    with pytest.raises(ValueError):          # the fused program is boxcar
        tpipe.Pipeline(PipelineConfig(**kw, filter_mode="fir"),
                       device="cpu").decode_wideband_u8(
            np.zeros(8000, np.uint8))
    pallas = tpipe.Pipeline(PipelineConfig(**kw, use_pallas=True),
                            device="cpu")
    with pytest.raises(ValueError):
        pallas.decode_wideband_u8(np.zeros(256_000, np.int16), fmt="cs16")
    pipe = tpipe.Pipeline(PipelineConfig(**kw), device="cpu")
    with pytest.raises(ValueError):           # raw of another format
        pipe.decode_wideband_u8(np.zeros(8000, np.uint8), fmt="cs16")


# ---------------------------------------------------------------- slot pressure

N_JUNK = 24          # junk triggers per channel, all earlier than any burst


def _with_junk(find_triggers, xp):
    """find_triggers plus N_JUNK slots per channel of junk triggers at
    q = 3.99 (just under the 4.0 threshold, as noise triggers sit),
    placed at even positions before the first real burst, so a
    time-ordered compaction would hand them every slot."""
    def wrapped(err, fr, max_candidates):
        t0, of, df, valid, q = find_triggers(err, fr, max_candidates)
        c = t0.shape[0]
        jt = np.tile(152 + 2 * np.arange(N_JUNK), (c, 1))
        if xp is torch:
            new = (torch.as_tensor(jt, dtype=t0.dtype),
                   torch.full((c, N_JUNK), 8.0), torch.zeros(c, N_JUNK),
                   torch.ones(c, N_JUNK, dtype=torch.bool),
                   torch.full((c, N_JUNK), 3.99))
            cat = lambda a, b: torch.cat([a, b], dim=1)
        else:
            new = (jnp.asarray(jt, t0.dtype), jnp.full((c, N_JUNK), 8.0),
                   jnp.zeros((c, N_JUNK)), jnp.ones((c, N_JUNK), bool),
                   jnp.full((c, N_JUNK), 3.99))
            cat = lambda a, b: jnp.concatenate([a, b.astype(a.dtype)], axis=1)
        return tuple(cat(a, b) for a, b in zip((t0, of, df, valid, q), new))
    return wrapped


def test_q_ranked_compaction_keeps_real_bursts(monkeypatch):
    """Junk triggers at q ~ 4 plus real preambles exceed max_out: every
    real burst keeps its decode slot on both backends."""
    wide, freqs, fc, truth = B.make_capture(FS, 2, 0.5)
    raw = B.to_u8(wide[: len(wide) - len(wide) % 2000])
    assert min(p for _c, _b, p, _l in truth) > 152 + 2 * N_JUNK
    _, tp = _pipes(freqs, fc, "stream")
    ch = tp.channelizer
    from vdlm2dec_tpu_torch.ops.ingest import raw_to_planes_split

    y = ch(*raw_to_planes_split(torch.from_numpy(raw), ch.p_in), split=True)
    max_out = len(truth) + 4               # < real + junk triggers
    assert 2 * N_JUNK > max_out
    monkeypatch.setattr(jpipe, "find_triggers",
                        _with_junk(jpipe.find_triggers, jnp))
    monkeypatch.setattr(tpipe, "find_triggers",
                        _with_junk(tpipe.find_triggers, torch))
    bufs = {
        "jax": np.asarray(jpipe._device_decode_packed(
            jnp.asarray(y.numpy()), 16, 512, max_out, sync_impl="stream")),
        "torch": tpipe.device_decode_packed(y, 16, 512, max_out,
                                            sync_impl="stream").numpy(),
    }
    jp = jpipe.Pipeline(jpipe.PipelineConfig(**_cfg_kw(freqs, fc, "stream")))
    for name, buf in bufs.items():
        stats = jpipe.packed_stats(buf)
        assert stats["candidates_overflow"] > 0, name
        assert stats["sync_candidates"] >= len(truth) + 2 * N_JUNK, name
        frames = _frames(jp._finish(jpipe.unpack_results(buf), 0))
        assert Counter(frames) == Counter((c, b) for c, b, *_ in truth), name
