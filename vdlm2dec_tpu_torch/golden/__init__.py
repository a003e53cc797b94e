"""Bit-level numpy codecs (header code, RS, CRC, HDLC, scrambler) that pin
the reference decoder's semantics: the host deframer and the stimulus use
them."""
