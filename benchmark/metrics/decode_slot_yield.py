"""decode_slot_yield: of the DecodedBursts the stream yielded in the window
(one per live decode slot that passed the header check), the share with a
CRC-valid frame (%)."""


def read(rec):
    return 100.0 * rec.bursts_framed / rec.bursts if rec.bursts else None
