"""The PyTorch port's multi-host worker, its output surface on the CPU:
--output json|text, --label-filter, --netjson, the capture formats and
the fail-fast flag checks, each over 2 gloo processes x 4 shards
(counterparts of tests/test_multihost.py; the decode parity with one
process and with the JAX worker is in tests/test_torch_multihost.py,
checkpoints and the SIGTERM drain in tests/test_torch_multihost_resume.py).
"""
import json
import re
import socket
from collections import Counter

import numpy as np
import pytest
import torch

from vdlm2dec_tpu import framegen as fg
from vdlm2dec_tpu import modulator as mod
from vdlm2dec_tpu.io.sdr import write_capture
from vdlm2dec_tpu_torch.parallel import multihost as tmh
from vdlm2dec_tpu_torch.parallel.multihost import launch_local

torch.set_num_threads(1)

FS = 2_000_000
MESH_ARGS = ["--time-shards", "8", "--max-symbols", "512",
             "--max-candidates", "4"]


def _cpu(n, worker_args, **kw):
    return launch_local(n, worker_args, local_devices=8 // n, device="cpu",
                        timeout=300, **kw)


def _frame_lines(outs):
    return Counter(line for out in outs for line in out.splitlines()
                   if line.startswith("FRAME "))


def _json_lines(outs):
    return Counter(line for out in outs for line in out.splitlines()
                   if line.startswith("{"))


def _wide(texts_at, t_raw, seed, gain=30.0, noise=1.0):
    """ACARS bursts (text, start in decimated samples) on the channel
    75 kHz above the centre, as complex samples at 2 Msps plus noise."""
    rng = np.random.default_rng(seed)
    total_dec = t_raw * 84 // 2000
    sig = np.zeros(total_dec, dtype=np.complex128)
    for text, st in texts_at:
        c = fg.acars_frame(text=text, label="Q0")
        sig += mod.synthesize_baseband(mod.make_burst([c]), start=st,
                                       total=total_dec)
    wide = mod.upsample_to_wideband(sig, FS, 75_000.0, total=t_raw) * gain
    return wide + noise * (rng.normal(size=t_raw)
                           + 1j * rng.normal(size=t_raw))


@pytest.fixture(scope="module")
def one_burst(tmp_path_factory):
    cap = str(tmp_path_factory.mktemp("tmh_json") / "mh_json.cu8")
    write_capture(cap, _wide([("MHJSON", 4000)], 250 * 2000, 23), "cu8")
    return ["--iq", cap, "--fc", "136900000", "136.975", *MESH_ARGS]


def test_worker_json_output_surface(one_burst):
    """--output json routes each host's owned bursts through the full
    FrameDecoder surface: the ACARS payload comes out as the JSON line the
    CLI would print, exactly once across hosts."""
    outs = _cpu(2, [*one_burst, "--output", "json", "--station", "MH",
                    "--start-time", "1e9", "--label-filter", "Q0:H1"])
    recs = [json.loads(line) for line in _json_lines(outs).elements()]
    assert len(recs) == 1
    (rec,) = recs
    assert rec["text"] == "MHJSON"
    assert rec["station_id"] == "MH"
    assert rec["freq"] == 136.975
    # no raw FRAME lines in decoded-output mode
    assert not any("FRAME " in out for out in outs)


def test_worker_text_output_surface(one_burst):
    """Text mode renders the reference-format block on the owning host."""
    outs = _cpu(2, [*one_burst, "--output", "text"])
    joined = "\n".join(outs)
    assert "ACARS" in joined and "MHJSON" in joined
    assert "Message :" in joined
    assert sum("MHJSON" in out for out in outs) == 1


def test_worker_label_filter(one_burst):
    """--label-filter keeps the listed ACARS labels only (the json surface
    test above lists the burst's label, Q0, and keeps it)."""
    dropped = _cpu(2, [*one_burst, "--output", "json", "--label-filter", "H1"])
    assert sum(_json_lines(dropped).values()) == 0
    assert all(o.splitlines()[-1].startswith("DONE") for o in dropped)


def test_worker_netjson_udp_alongside_frames(one_burst):
    """--netjson sends each owned frame's JSON record over UDP (out.c -j)
    while stdout keeps the FRAME lines (default --output frames)."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(60)
        port = rx.getsockname()[1]
        outs = _cpu(2, [*one_burst, "--netjson", f"127.0.0.1:{port}",
                        "--station", "MH"])
        assert sum(_frame_lines(outs).values()) == 1
        data, _ = rx.recvfrom(65536)
    finally:
        rx.close()
    obj = json.loads(data.decode())
    assert obj["text"] == "MHJSON"
    assert obj["station_id"] == "MH"


@pytest.mark.parametrize("fmt", ["cs16", "f32real"])
def test_worker_formats(tmp_path, fmt):
    """The worker decodes the other capture formats too: cs16 (complex
    int16) and the airspy-style f32real arrangement (channels at fc +
    fs/4, imaginary plane zero)."""
    t_raw = 250 * 2000
    text = {"cs16": "CS16FMT", "f32real": "REALFMT"}[fmt]
    content = fg.acars_frame(text=text, label="Q0")
    if fmt == "cs16":
        cap = str(tmp_path / "mh.cs16")
        write_capture(cap, _wide([(text, 4000)], t_raw, 31, gain=900.0,
                                 noise=30.0), "cs16")
        args = ["--iq", cap, "--format", "cs16", "--fc", "136900000"]
    else:
        # real capture, channel at fo = freq - (fc + fs/4)
        rng = np.random.default_rng(31)
        freq, fc = 136_975_000, 136_800_000
        fo = freq - (fc + FS / 4)
        bb = mod.synthesize_baseband(mod.make_burst([content]), start=4000,
                                     total=t_raw * 84 // 2000)
        tt = np.arange(t_raw) / (FS / 84_000)
        i0 = np.clip(np.floor(tt).astype(int), 0, len(bb) - 2)
        frac = tt - i0
        up = bb[i0] * (1 - frac) + bb[i0 + 1] * frac
        real_sig = 2.0 * np.real(
            up * np.exp(1j * 2 * np.pi * fo / FS * np.arange(t_raw)))
        real_sig = (real_sig * 30 + rng.normal(size=t_raw)).astype(np.float32)
        cap = str(tmp_path / "mh.f32")
        write_capture(cap, real_sig, "f32real")
        args = ["--iq", cap, "--format", "f32real", "--fc", str(fc)]
    frames = _frame_lines(_cpu(2, [*args, "136.975", *MESH_ARGS]))
    assert sum(frames.values()) == 1
    (line,) = frames
    hexed = re.match(r"FRAME 0 \d+ ([0-9a-f]+)", line).group(1)
    assert bytes.fromhex(hexed)[1:-3] == bytes(content)


@pytest.mark.parametrize("flags,message", [
    (["--checkpoint", "c"], "--checkpoint requires --block-seconds"),
    (["--abort-after-window", "1"],
     "--abort-after-window requires --block-seconds"),
    (["--label-filter", "Q0"], "--label-filter needs --output json|text"),
])
def test_worker_fails_fast_on_inert_flags(flags, message, capsys):
    """Flag combinations that would do nothing are refused before any
    process group or device is touched (exit 2)."""
    with pytest.raises(SystemExit) as e:
        tmh._worker_main(["136.975", "--iq", "cap.cu8", "--device", "cpu",
                          *flags])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
