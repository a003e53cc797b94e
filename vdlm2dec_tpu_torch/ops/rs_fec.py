"""Batched RS(255,249) decoder over GF(2^8), byte-exact to rs.c:81-291.

Every GF product is one lookup in the 64 KiB product table; sums in the
field are XORs.  Syndromes, Chien search and the Forney evaluations are
products of per-row coefficients with per-position constants
(_tables.rs_position_tables), XOR-reduced; the Berlekamp-Massey recursion
runs its 6 fixed, erasure-seeded steps elementwise over the row batch.
"""
from __future__ import annotations

import functools

import torch

from .._tables import EXPN, LOGN, erasure_init, gf_mul_table, rs_position_tables
from ..constants import GF_A0, RS_N, RS_ROOTS


@functools.lru_cache(maxsize=None)
def _rs_tables(device: torch.device) -> dict[str, torch.Tensor]:
    lam_init, n_eras = erasure_init()
    arrays = dict(rs_position_tables(), exp=EXPN, log=LOGN,
                  mul=gf_mul_table(), lam_init=lam_init, n_eras=n_eras)
    return {k: torch.as_tensor(v, dtype=torch.int64, device=device)
            for k, v in arrays.items()}


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis, by pairwise folding."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        y = x[..., :h] ^ x[..., h:2 * h]
        if n % 2:
            y = torch.cat([y, x[..., 2 * h:]], dim=-1)
        x = y
    return x[..., 0]


def rs_decode_rows(rows: torch.Tensor, eras_class: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """rows: (M, 255) uint8; eras_class: (M,) in {0, 1, 2} (no erasures,
    {253, 254}, {251..254}).  Returns (corrected rows (M, 255) uint8,
    count (M,) int32) with count as rs() returns it: 0 clean, n
    corrections, -1 uncorrectable."""
    tb = _rs_tables(rows.device)
    mul, exp, log = tb["mul"], tb["exp"], tb["log"]

    def gmul(a, b):
        return mul[a * 256 + b]

    data = rows.to(torch.int64)
    m = data.shape[0]

    # syndromes s_i = XOR_j d_j alpha^{(FCR+i)(254-j)}
    s = _xor_reduce(gmul(data[:, None, :], tb["syn"][None]))    # (M, 6)
    syn_zero = (s == 0).all(dim=1)

    # Berlekamp-Massey, erasure-initialised, 6 static steps
    ec = eras_class.to(torch.int64)
    lam = tb["lam_init"][ec]                                    # (M, 7)
    no_eras = tb["n_eras"][ec]
    b = log[lam]                                                # log form
    el = no_eras
    a0_col = torch.full((m, 1), GF_A0, dtype=torch.int64, device=rows.device)
    for r in range(1, RS_ROOTS + 1):
        active = r > no_eras
        discr = torch.zeros_like(no_eras)
        for i in range(r):
            discr = discr ^ gmul(lam[:, i], s[:, r - 1 - i])
        dlog = log[discr]
        dz = discr == 0
        b_shift = torch.cat([a0_col, b[:, :-1]], dim=1)
        # t = lambda - discr * x * b
        bx = torch.where(b[:, :-1] != GF_A0,
                         exp[(dlog[:, None] + b[:, :-1]) % 255], 0)
        t = torch.cat([lam[:, :1], lam[:, 1:] ^ bx], dim=1)
        upd = 2 * el <= (r + no_eras - 1)
        el_new = torch.where(upd, r + no_eras - el, el)
        b_upd = torch.where(lam != 0, (log[lam] - dlog[:, None] + 255) % 255,
                            GF_A0)
        b_nz = torch.where(upd[:, None], b_upd, b_shift)
        lam_new = torch.where(dz[:, None], lam, t)
        b_new = torch.where(dz[:, None], b_shift, b_nz)
        lam = torch.where(active[:, None], lam_new, lam)
        b = torch.where(active[:, None], b_new, b)
        el = torch.where(active & ~dz, el_new, el)

    idx7 = torch.arange(RS_ROOTS + 1, device=rows.device)
    deg_lambda = torch.where(lam != 0, idx7[None, :], 0).amax(dim=1)

    # Chien search: val(q) = 1 ^ XOR_d lam_d alpha^{d(q+1)}
    val = _xor_reduce(gmul(lam[:, 1:, None], tb["chien"][None])
                      .transpose(1, 2)) ^ 1                     # (M, 255)
    root_mask = val == 0
    n_roots = root_mask.sum(dim=1)

    # omega = s * lambda mod x^6
    omega = []
    for i in range(RS_ROOTS):
        acc = torch.zeros_like(no_eras)
        for jj in range(i + 1):
            acc = acc ^ gmul(s[:, i - jj], lam[:, jj])
        omega.append(acc)
    omega = torch.stack(omega, dim=1)                           # (M, 6)

    # Forney at every position: magnitude = omega(.) * num2 / lambda'(.)
    num12 = _xor_reduce(gmul(omega[:, :, None], tb["omega"][None])
                        .transpose(1, 2))
    den = _xor_reduce(gmul(lam[:, 1::2, None], tb["den"][None])
                      .transpose(1, 2))
    mag = gmul(num12, tb["inv"][den])                           # inv[0] = 0

    # Forney failure semantics (rs.c:257-283): the reference walks roots
    # from the highest position down and bails at the first den == 0, so
    # corrections above the failing position are already applied
    bad = root_mask & (den == 0)
    bad_den = bad.any(dim=1)
    pos_idx = torch.arange(RS_N, device=rows.device)[None, :]
    bad_threshold = torch.where(bad, pos_idx, -1).amax(dim=1)
    deg_ok = ~syn_zero & (n_roots == deg_lambda)
    apply_mask = (root_mask & deg_ok[:, None]
                  & (pos_idx > bad_threshold[:, None]))
    fixed = (data ^ torch.where(apply_mask, mag, 0)).to(torch.uint8)
    count = torch.where(
        syn_zero, 0,
        torch.where((n_roots == deg_lambda) & ~bad_den, n_roots, -1))
    return fixed, count.to(torch.int32)
