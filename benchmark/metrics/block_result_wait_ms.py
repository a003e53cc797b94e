"""block_result_wait_ms: from the due time of a block's last core byte on the
feed to the stream's yield of that block's bursts, mean over the blocks due
inside the window (ms).  The live route hands out each block before it reads
on, so the blocks' waits lie close together and the mean reads what a
median would; the mean is taken because every block's wait counts whole in
it, a block that lags moves it, and the means of the parts of the wait that
the port's block spans measure (dispatch wait, dispatch to ready, ready
wait, finish) add up to it, where medians would not."""
import statistics


def read(rec):
    return statistics.fmean(rec.block_waits_ms) if rec.block_waits_ms else None
