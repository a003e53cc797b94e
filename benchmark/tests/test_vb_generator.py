"""The traffic generator: one seed gives the same bytes and truth, another
seed other ones with the same work; its bursts are the port's modulator's;
its cu8 captures are pinned, and its f32real captures carry the same
bursts on the Airspy's grid."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import TINY_CONFIGS, TINY_TRAFFIC
from vbench import gen, protocol

torch.set_num_threads(1)
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(kind, name):
    with open(os.path.join(BENCH, kind, name + ".json")) as fh:
        return json.load(fh)


def _small():
    cfg = _load("configs", "rtl8")
    cfg.update(channels=2)
    tr = _load("traffic", "busy-file")
    tr.update(seconds=1.5, text_max=60)
    return cfg, tr


def test_same_seed_same_capture():
    cfg, tr = _small()
    a = gen.make_capture(cfg, tr, 2**31 + 11, "cpu")
    b = gen.make_capture(cfg, tr, 2**31 + 11, "cpu")
    assert np.array_equal(a.raw, b.raw)
    assert [(x.chan, x.start, x.length, x.fields) for x in a.bursts] == \
        [(x.chan, x.start, x.length, x.fields) for x in b.bursts]


def test_other_seed_other_capture_same_work():
    cfg, tr = _small()
    a = gen.make_capture(cfg, tr, 5, "cpu")
    b = gen.make_capture(cfg, tr, 6, "cpu")
    assert not np.array_equal(a.raw, b.raw)
    assert [x.fields for x in a.bursts] != [x.fields for x in b.bursts]
    # the shape seed fixes each channel's bursts: the same kinds and text
    # lengths in another order
    for ci in range(2):
        ka = sorted((x.kind, len(x.fields.get("text", ""))) for x in a.bursts if x.chan == ci)
        kb = sorted((x.kind, len(x.fields.get("text", ""))) for x in b.bursts if x.chan == ci)
        assert ka == kb


@pytest.mark.parametrize("kind,text_len", [("acars", 20), ("acars", 200), ("xid", 0)])
def test_bursts_are_the_modulators(kind, text_len):
    from vdlm2dec_tpu_torch import modulator as mod

    rng = np.random.default_rng(3)
    fleet, regs, ground = gen._fleet(rng, 8)
    f = gen._fields(kind, text_len, rng, fleet, ground, regs, 17)
    frame = gen.acars_frame(f) if kind == "acars" else gen.xid_frame(f)
    ph = gen.burst_phases([frame])[0]
    plan = mod.make_burst([np.frombuffer(frame, np.uint8)])
    assert plan.nbrow == 1
    assert len(ph) == len(plan.symbol_phases)
    assert np.abs(np.angle(np.exp(1j * (ph - plan.symbol_phases)))).max() < 1e-9
    imp = (-211.0, 2.5, 0.61, 7.5)
    length = len(ph) * 8 + 128
    bb = gen._shape_channel([ph], [40], [imp], length + 80, "cpu").numpy()
    ref = mod.synthesize_baseband(plan, start=0, total=None, cfo_hz=imp[0],
                                  phase0=imp[1], timing_frac=imp[2], amplitude=imp[3])
    assert np.abs(bb[40:40 + length] - ref).max() < 1e-4
    assert not bb[:40].any() and not bb[40 + length:].any()


def test_rs_parity_is_the_golden_encoders():
    from vdlm2dec_tpu_torch.golden.codec import rs_encode_row

    rows = np.random.default_rng(4).integers(0, 256, (6, 249)).astype(np.uint8)
    par = gen._rs_parity(rows)
    for r in range(6):
        assert np.array_equal(par[r], rs_encode_row(rows[r]))


# sha256 of the cu8 captures of conftest's tiny rtl8 (busy-file) and tiny
# band760 (sparse-file), generated on the CPU, recorded before f32real was
# added to the generator: the cu8 path is the same to the byte
CU8_PINS = {
    ("rtl8", "busy-file", 2**31 + 7):
        "aebd5f61e221302d9de959069f3be7cbad57cf6ab3309ad2355f3251a9030b8c",
    ("rtl8", "busy-file", 12345):
        "3b867f3619ecd2fd1b8f77e1562c42fc7110b1e596a6d1984b33c3fceec0af17",
    ("band760", "sparse-file", 2**31 + 7):
        "4030707b13a043a7e8bdc9e2dc8198f17e632b817cd4c6fa0710028902e3335b",
    ("band760", "sparse-file", 12345):
        "2c57bd937c932786f01241874d66de22efea611f8e41b1b6f8a9496977790514",
}


def _tiny(name, traffic):
    cfg = _load("configs", name)
    cfg.update(TINY_CONFIGS[name])
    tr = _load("traffic", traffic)
    tr.update(TINY_TRAFFIC)
    if tr.get("active_every", 1) > 1:
        tr["active_every"] = 4
    return cfg, tr


@pytest.mark.parametrize("name,traffic,seed", sorted(CU8_PINS))
def test_cu8_captures_are_pinned(name, traffic, seed):
    cap = gen.make_capture(*_tiny(name, traffic), seed, "cpu")
    assert cap.fmt == "cu8" and cap.raw.dtype == np.uint8
    assert cap.samples == len(cap.raw) // 2 == 8_000_000
    assert hashlib.sha256(cap.raw.tobytes()).hexdigest() == CU8_PINS[(name, traffic, seed)]


def _airspy():
    from vdlm2dec_tpu_torch.io.sdr import choose_fc_airspy

    cfg, tr = _small()
    cfg.update(format="f32real", fs=5_000_000)
    cfg["fc_hz"] = choose_fc_airspy(gen.channel_plan(cfg), cfg["fs"])
    return cfg, tr


def test_f32real_capture_carries_the_same_bursts_on_the_airspy_grid():
    cfg, tr = _airspy()
    cap = gen.make_capture(cfg, tr, 2**31 + 11, "cpu")
    ref = gen.make_capture(_small()[0], tr, 2**31 + 11, "cpu")
    assert cap.fmt == "f32real" and cap.raw.dtype == np.float32
    assert cap.samples == len(cap.raw) == int(5_000_000 * tr["seconds"])
    grid = cap.raw * 2048.0
    assert np.array_equal(grid, np.round(grid))
    assert grid.min() >= -2048 and grid.max() <= 2047 and grid.std() > 1
    # the same draws in the same order: the same truth as the cu8 capture
    assert [(b.chan, b.start, b.length, b.fields, b.imp) for b in cap.bursts] == \
        [(b.chan, b.start, b.length, b.fields, b.imp) for b in ref.bursts]


def test_unknown_format_is_refused(tiny_root):
    from vbench import cells

    cfg, tr = _small()
    cfg["format"] = "cs16"
    with pytest.raises(ValueError, match="'format'"):
        gen.make_capture(cfg, tr, 1, "cpu")
    del cfg["format"]
    with pytest.raises(ValueError, match="'format'"):
        protocol.capture_format(cfg)
    path = tiny_root / "benchmark" / "configs" / "rtl8.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), format="cf32")))
    spec = cells.load_spec(str(tiny_root))
    with pytest.raises(ValueError, match="'format'"):
        cells.config(spec, "rtl8", root=str(tiny_root))


def test_format_table_is_the_ports():
    from vdlm2dec_tpu_torch._tables import RAW_FMT
    from vdlm2dec_tpu_torch.io.live import _BYTES_PER_SAMPLE

    for fmt in ("cu8", "f32real"):
        assert protocol.RAW_FMT[fmt] == RAW_FMT[fmt]
        assert protocol.bytes_per_sample(fmt) == _BYTES_PER_SAMPLE[fmt]
    assert set(protocol.RAW_FMT) == {"cu8", "f32real"}
