"""Burst bit/byte assembly: soft bits -> bytes -> deinterleaved RS block.

The reference fills a (rows, 255) block column-major while zero-padding
the shortened last row (putbit, d8psk.c:117-205).  That map is a pure
function of (nbrow, nlbyte), so its inverse (row, col) -> transmitted
byte index is tabulated once (_tables.inverse_fill_tables) and the
deinterleave is one gather.
"""
from __future__ import annotations

import functools

import torch

from .._tables import MAX_TX_BYTES, N_GEOM, inverse_fill_tables
from ..constants import MAX_ROWS, RS_N


@functools.lru_cache(maxsize=None)
def _fill_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    inv, counts = inverse_fill_tables()
    return (torch.as_tensor(inv, device=device),
            torch.as_tensor(counts, device=device))


def assemble_blocks(soft_data: torch.Tensor, nbrow: torch.Tensor,
                    nlbyte: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """soft_data: (N, >= 8*2040) descrambled soft bits after the header.
    Returns (blocks (N, 8, 255) uint8, consumed bits (N,) int32)."""
    n = soft_data.shape[0]
    inv, counts = _fill_tables(soft_data.device)
    hard = (soft_data[:, : 8 * MAX_TX_BYTES] > 0.5).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=soft_data.device)
    tx_bytes = (hard.reshape(n, MAX_TX_BYTES, 8) * weights).sum(dim=-1)
    # rejected headers (nbrow > 8) index past the table; clamp to its last
    # geometry as the JAX gather does
    g = torch.clamp(nbrow.to(torch.int64) * 250 + nlbyte.to(torch.int64),
                    0, N_GEOM - 1)
    gmap = inv[g].to(torch.int64)                    # (N, 8, 255)
    vals = torch.gather(tx_bytes, 1, gmap.clamp(min=0).reshape(n, -1))
    blocks = torch.where(gmap >= 0, vals.reshape(n, MAX_ROWS, RS_N), 0)
    return blocks.to(torch.uint8), 8 * counts[g]
