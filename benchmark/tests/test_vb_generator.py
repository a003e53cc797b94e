"""The traffic generator: one seed gives the same bytes and truth, another
seed other ones with the same work; its bursts are the port's modulator's."""
import json
import os

import numpy as np
import pytest
import torch

from vbench import gen

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
