"""h2d_roofline_share: the least time of one block's raw upload (its bytes
over the host link's peak) over the block's mean upload time in the trace
(the host-to-device copy time of h2d_ms_per_block), in %.

A block's raw bytes: the file route uploads every block's whole-period
segment, k1_shape's decimated samples x p_in / p_out raw samples (p_in /
p_out = fs / 84 kHz) at the capture format's bytes a sample.  The peak:
the NVIDIA H100 SXM's host link, PCIe Gen5 x16, 128 GB/s both ways (NVIDIA
H100 data sheet), so 64 GB/s host to device."""
from vbench.protocol import bytes_per_sample, capture_format
from vbench.reference import DEMOD_RATE

H2D_BYTES_PER_S = 64e9           # PCIe Gen5 x16, one way


def block_bytes(rec) -> int:
    """Raw bytes one block uploads."""
    samples = rec.k1_shape[1] * int(rec.config["fs"]) // DEMOD_RATE
    return samples * bytes_per_sample(capture_format(rec.config))


def read(rec):
    t = rec.trace
    if not t or rec.trace_blocks <= 0 or rec.k1_shape is None:
        return None
    total = sum(s for name, (_n, s) in t["kernels"].items()
                if name.startswith("Memcpy HtoD"))
    if total <= 0:
        return None
    return 100.0 * (block_bytes(rec) / H2D_BYTES_PER_S) / (total / rec.trace_blocks)
