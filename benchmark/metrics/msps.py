"""msps: wideband capture samples of the blocks decoded and emitted as lines
inside the window, over the window's seconds (Msamples/s)."""


def read(rec):
    if rec.traffic.get("mode") != "file" or rec.window_s <= 0:
        return None
    return rec.samples / rec.window_s / 1e6
