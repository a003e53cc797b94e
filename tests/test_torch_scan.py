"""The port's frequency scan (python -m vdlm2dec_tpu_torch.scan) against
the JAX package's tools/scan.py, on the CPU: the port runs with jax
blocked and must print the same channel list and frame counts."""
import os
import subprocess
import sys

import numpy as np

from vdlm2dec_tpu import framegen as fg
from vdlm2dec_tpu import modulator as mod
from vdlm2dec_tpu.io.sdr import write_capture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_scan_matches_jax_scan(tmp_path):
    rng = np.random.default_rng(5)
    fs, fc = 2_000_000, 136_900_000
    total = fs // 2
    wide = np.zeros(total, dtype=np.complex128)
    for freq, n in {136_975_000: 2, 136_650_000: 1}.items():
        bb = np.zeros(42_000, dtype=np.complex128)
        for k in range(n):
            c = fg.acars_frame(text=f"SCAN{k}", label="Q0")
            bb += mod.synthesize_baseband(mod.make_burst([c]),
                                          start=1500 + 9000 * k,
                                          total=42_000)
        wide += mod.upsample_to_wideband(bb, fs, freq - fc, total=total)
    wide = wide * 40 + (rng.normal(size=total) + 1j * rng.normal(size=total))
    cap = str(tmp_path / "scan.cu8")
    write_capture(cap, wide, "cu8")
    flags = ["--iq", cap, "--fc", str(fc), "--max-rows", "2",
             "--start", "136.6", "--stop", "137.0", "--block-seconds", "0.25"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = subprocess.run(
        [sys.executable, "-c",
         "import sys\nsys.modules['jax'] = None\n"
         "from vdlm2dec_tpu_torch import scan\n"
         "sys.exit(scan.main(sys.argv[1:]))\n", *flags, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert port.returncode == 0, port.stderr[-2000:]
    jax_run = subprocess.run(
        [sys.executable, "tools/scan.py", *flags], capture_output=True,
        text=True, timeout=600, cwd=REPO, env=env)
    assert jax_run.returncode == 0, jax_run.stderr[-2000:]
    assert port.stdout == jax_run.stdout
    assert port.stdout.splitlines() == ["136.975 MHz: 2 frames",
                                        "136.650 MHz: 1 frames"]
    assert "# scanning 13 channels 136.600..136.975 MHz" in port.stderr
    assert "# scanning 13 channels 136.600..136.975 MHz" in jax_run.stderr
