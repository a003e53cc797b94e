"""Where the trigger sets of two sync metrics may differ.

Two streams that differ in the last bits (a kernel's output and its plain
version's, summed in another order) give sync metrics `err` that differ in
the last bits too, and `ops.demod.find_triggers` turns a metric into
triggers by two threshold tests: a position t fires where err[t-2] < 4 and
err[t] > err[t-2].  A trigger that is on one side only (a flip) is
acceptable only where such a test was decided within the metric's
tolerance.  Two rules, on numpy `err` arrays of shape (C, T):

  flip_at_threshold     the flipped trigger's own tests are marginal
  flip_by_suppression   some firing decision in the flip's sync window is
                        marginal on both sides: a firing, kept or not,
                        suppresses every trigger up to 136 samples after
                        it, so one marginal decision can move a trigger
                        that is itself far from the threshold
"""
from __future__ import annotations

import numpy as np

from .constants import SYNC_THRESHOLD
from .ops.demod import find_triggers

ERR_TOL = (1e-4, 1e-4)           # (rtol, atol) of the sync metric
FIRST_VALID = 150                # find_triggers' first metric position
SYNC_WINDOW = 136                # a firing suppresses this many samples


def trigger_set(err, fr, max_candidates: int) -> set[tuple[int, int]]:
    """The (channel, position) pairs of find_triggers' valid slots (err
    and fr are torch tensors, on any device)."""
    t0, _of, _df, valid, _q = find_triggers(err, fr, max_candidates)
    t0, valid = t0.cpu().numpy(), valid.cpu().numpy()
    return {(int(c), int(t0[c, k])) for c, k in zip(*np.nonzero(valid))}


def _marginal(e0, e1, tol) -> np.ndarray:
    """Whether either test of a firing decision (e1 < threshold, e0 > e1)
    lies within the tolerance."""
    rtol, atol = tol
    width = atol + rtol * np.abs(e1)
    return (np.abs(e1 - SYNC_THRESHOLD) <= width) | (np.abs(e0 - e1) <= width)


def flip_at_threshold(err: np.ndarray, c: int, t: int, tol=ERR_TOL) -> bool:
    """The trigger (c, t) sits where one of its own two tests is within
    the tolerance."""
    return bool(_marginal(float(err[c, t]), float(err[c, t - 2]), tol))


def firings(e: np.ndarray, lo: int) -> np.ndarray:
    """find_triggers' firing rule at positions lo, lo + 1, .. of one
    channel, given its err from position lo - 2 on."""
    pos = lo + np.arange(len(e) - 2)
    return ((pos >= FIRST_VALID) & (pos % 2 == 1)
            & (e[:-2] < SYNC_THRESHOLD) & (e[2:] > e[:-2]))


def flip_by_suppression(err_a: np.ndarray, err_b: np.ndarray, c: int, t: int,
                        tol=ERR_TOL) -> tuple[bool, list[dict]]:
    """(explained, readings) for a trigger (c, t) that one of the two
    metrics has and the other has not.  readings: every position from
    t - 136 to t whose firing decision differs between the sides, with
    e1 = err[t-2] and e0 = err[t] of both.  Explained: there is such a
    position, and at each of them the decision is marginal on both sides."""
    lo = max(t - SYNC_WINDOW, 2)
    ea, eb = (e[c, lo - 2: t + 1] for e in (err_a, err_b))
    differ = np.nonzero(firings(ea, lo) != firings(eb, lo))[0]
    near = np.ones(len(differ), bool)
    for e in (ea, eb):
        near &= _marginal(e[2:][differ], e[:-2][differ], tol)
    readings = [dict(t=int(lo + i),
                     e1=[float(ea[i]), float(eb[i])],
                     e0=[float(ea[i + 2]), float(eb[i + 2])])
                for i in differ]
    return len(differ) > 0 and bool(near.all()), readings
