"""Batched ML decode of the (25,20) burst-header block code.

The reference's "viterbi" (viterbi.c:23-96) is an exhaustive max-product
trellis over the 32 parity-syndrome states; here it runs in log domain
over an (N, 32) batch: 25 steps of a gather by the fixed permutation
s -> s ^ H[n] plus an elementwise max, then a 25-step traceback.
"""
from __future__ import annotations

import torch

from .._tables import PERM
from ..constants import HEADER_STATES, MAX_ROWS, ROW_DATA_BITS

_NEG = -1e30


def header_decode(soft: torch.Tensor):
    """soft: (N, 25) P(bit = 1).  Returns (length, nbrow, nlbyte, ok), each
    (N,); ok is False when the length is rejected (len < 96 or nbrow > 8,
    d8psk.c:97-107)."""
    n = soft.shape[0]
    dev = soft.device
    v = soft.to(torch.float32).clone()
    v[:, :3] = 0.0                          # bits 0-2 forced to 0 (d8psk.c:81)
    l1 = torch.log(torch.clamp(v, 1e-37, 1.0))
    l0 = torch.log(torch.clamp(1.0 - v, 1e-37, 1.0))
    perm = torch.as_tensor(PERM, device=dev)
    states = torch.arange(HEADER_STATES, device=dev)

    p = torch.full((n, HEADER_STATES), _NEG, dtype=torch.float32, device=dev)
    p[:, 0] = 0.0
    bits = []
    for k in range(perm.shape[0]):
        pm = perm[k]
        one = p[:, pm] + l1[:, k, None]     # path arriving via bit 1
        zero = p + l0[:, k, None]
        # tie-break of viterbi.c's source-state order: for destination d
        # the bit-1 write comes first iff d ^ H[n] < d, and a later write
        # needs a strictly greater metric
        bits.append((one > zero) | ((one == zero) & (pm < states)[None, :]))
        p = torch.maximum(one, zero)

    # traceback from state 0; tx[k] = transmitted bit k
    state = torch.zeros(n, dtype=torch.int64, device=dev)
    tx = [None] * len(bits)
    for k in reversed(range(len(bits))):
        b = torch.gather(bits[k], 1, state[:, None])[:, 0]
        state = torch.where(b, perm[k][state], state)
        tx[k] = b.to(torch.int64)
    # length: bits 3..19, LSB first
    length = sum(tx[3 + i] << i for i in range(17)).to(torch.int32)
    nbrow = length // ROW_DATA_BITS + 1
    nlbyte = (length % ROW_DATA_BITS + 7) // 8
    ok = (length >= 96) & (nbrow <= MAX_ROWS)
    return length, nbrow, nlbyte, ok
