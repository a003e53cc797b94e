"""Host-side application layer: deframing, AVLC parse, ACARS/XID decode,
outputs.  Irregular byte and text processing on tiny data volumes, kept on
the host CPU; the device path ends at RS-corrected bursts."""
