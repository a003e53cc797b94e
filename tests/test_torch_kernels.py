"""The port's hand-written CUDA kernels against their plain versions.

This file imports no jax, so it also runs where the card is:

    python -m pytest --noconftest tests/test_torch_kernels.py

(--noconftest skips tests/conftest.py, which sets up jax for the other
test files).  Tests marked `cuda` skip without a CUDA card.
"""
import numpy as np
import pytest
import torch

from vdlm2dec_tpu_torch.ops import sync

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

# the kernel runs the plain version's float32 operations in the same
# order; the tolerance is the one the JAX package holds its own two sync
# paths to (tests/test_fused_sync.py), kept in case an atan2 ulp differs
ERR_TOL = dict(rtol=1e-4, atol=1e-4)
FR_TOL = dict(rtol=1e-4, atol=1e-5)


def _stream(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape + (2,)).astype(np.float32) * 30


@pytest.mark.parametrize("mode", sync.MODES)
def test_cpu_tensor_takes_plain_version(mode):
    y = torch.from_numpy(_stream((2, 3000), 1))
    before = dict(sync.launches)
    err, fr = sync.sync_scan(y, mode)
    assert sync.launches == before
    ref = sync.sync_scan_stream_ref if mode == "stream" \
        else sync.sync_scan_fused_ref
    err_r, fr_r = ref(y)
    assert torch.equal(err, err_r) and torch.equal(fr, fr_r)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 211_848), (3, 1_000), (1, 130)])
@pytest.mark.parametrize("mode", sync.MODES)
def test_sync_kernel_matches_plain_on_card(mode, shape):
    """On a CUDA tensor the wrapper launches csrc/sync_scan.cu (one launch
    counted) and agrees with the plain version of its mode, including
    ragged tile edges and a stream shorter than the sync window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync kernel has no CPU mode")
    y = torch.tensor(_stream(shape, 3), device="cuda")
    before = sync.launches[mode]
    err, fr = sync.sync_scan(y, mode)
    torch.cuda.synchronize()
    assert sync.launches[mode] == before + 1
    ref = sync.sync_scan_stream_ref if mode == "stream" \
        else sync.sync_scan_fused_ref
    err_r, fr_r = ref(y)
    np.testing.assert_allclose(err.cpu().numpy(), err_r.cpu().numpy(),
                               **ERR_TOL)
    np.testing.assert_allclose(fr.cpu().numpy(), fr_r.cpu().numpy(), **FR_TOL)


@pytest.mark.cuda
def test_stream_decode_on_second_card_matches_first():
    """With cuda:0 current, a decode on cuda:1 launches the kernel and
    copies its packed rows to the host on cuda:1's stream: the fetch
    waits for that copy, and the frames equal cuda:0's and the truth."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import bench
    from vdlm2dec_tpu_torch._tables import PipelineConfig
    from vdlm2dec_tpu_torch.pipeline import Pipeline

    fs = 2_000_000
    wide, freqs, fc, truth = bench.make_capture(fs, 2, 1.0)
    raw = bench.to_u8(wide[: len(wide) - len(wide) % 2000])
    frames = {}
    for dev in ("cuda:0", "cuda:1"):
        cfg = PipelineConfig(freqs_hz=[float(f) for f in freqs], fs=fs,
                             fc_hz=float(fc), max_candidates=16,
                             max_symbols=512, max_out=48)
        pipe = Pipeline(cfg, device=dev)
        before = sync.launches["stream"]
        frames[dev] = sorted(
            (b.channel, bytes(bytearray(f[1:-3])))
            for bs in pipe.stream_wideband_u8(raw, block_seconds=0.25)
            for b in bs for f in b.frames)
        assert sync.launches["stream"] > before
    assert torch.cuda.current_device() == 0
    assert frames["cuda:1"] == frames["cuda:0"] == \
        sorted((c, b) for c, b, *_ in truth)
