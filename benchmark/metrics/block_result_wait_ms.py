"""block_result_wait_ms: from the due time of a block's last core byte on the
feed to the stream's yield of that block's bursts, mean over the blocks due
inside the window (ms).  The mean, not the median: the live route yields
blocks in pairs, so waits alternate between about one and two block
periods, and a median would follow the parity of the window's block count."""
import statistics


def read(rec):
    return statistics.fmean(rec.block_waits_ms) if rec.block_waits_ms else None
