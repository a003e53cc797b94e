"""host_output_ms_per_block: harness-timed FrameDecoder.process_burst over a
block's bursts, per block counted in the window (ms)."""


def read(rec):
    return 1e3 * rec.output_s / rec.blocks if rec.blocks else None
