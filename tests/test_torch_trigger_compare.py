"""The two rules that say where the trigger sets of two sync metrics may
differ (vdlm2dec_tpu_torch.trigger_compare), on synthetic metrics: each
accepts a flip that a marginal threshold test explains and rejects one
that nothing near the threshold explains."""
import numpy as np
import pytest
import torch

from vdlm2dec_tpu_torch.trigger_compare import (ERR_TOL, firings,
                                                flip_at_threshold,
                                                flip_by_suppression,
                                                trigger_set)

T = 1200


def metric(dips: dict) -> np.ndarray:
    """(1, T) err, 9.0 everywhere but at the given {position: value}."""
    err = np.full((1, T), 9.0, np.float32)
    for t, v in dips.items():
        err[0, t] = v
    return err


def triggers(err: np.ndarray) -> set:
    e = torch.from_numpy(err)
    return trigger_set(e, torch.zeros_like(e), 8)


def test_firings_is_find_triggers_rule_before_suppression():
    """Isolated dips (further apart than a sync window): every firing is
    a trigger, two samples after the dip."""
    err = metric({299: 1.0, 600: 1.0, 801: 3.9999, 1001: 4.0})
    fired = np.nonzero(firings(err[0], 2))[0] + 2
    assert fired.tolist() == [301, 803]        # 600 + 2 is even, 4.0 is not < 4
    assert triggers(err) == {(0, 301), (0, 803)}


def test_a_firing_suppresses_the_next_sync_window():
    """The firing at 301 suppresses positions up to 301 + 136."""
    assert triggers(metric({299: 1.0, 401: 1.0, 435: 1.0})) == {(0, 301)}
    assert triggers(metric({299: 1.0, 437: 1.0})) == {(0, 301), (0, 439)}


@pytest.mark.parametrize("a, b", [(3.99999, 4.00001), (4.00001, 3.99999)])
def test_flip_at_the_threshold_is_explained_by_both_rules(a, b):
    err_a, err_b = metric({499: a}), metric({499: b})
    flips = triggers(err_a) ^ triggers(err_b)
    assert flips == {(0, 501)}
    assert flip_at_threshold(err_a, 0, 501) and flip_at_threshold(err_b, 0, 501)
    ok, readings = flip_by_suppression(err_a, err_b, 0, 501)
    assert ok and [r["t"] for r in readings] == [501]
    assert readings[0]["e1"] == [pytest.approx(a), pytest.approx(b)]
    assert readings[0]["e0"] == [9.0, 9.0]


def test_marginal_rise_counts_as_at_the_threshold():
    """The second test, e0 > e1, decided in the last bits."""
    err_a = metric({499: 2.0, 501: 2.0001})
    err_b = metric({499: 2.0, 501: 2.0})
    assert triggers(err_a) == {(0, 501)} and triggers(err_b) == {(0, 503)}
    assert flip_at_threshold(err_a, 0, 501)
    assert flip_by_suppression(err_a, err_b, 0, 501)[0]


def test_flip_away_from_the_threshold_is_rejected_by_both_rules():
    err_a, err_b = metric({499: 1.0}), metric({499: 5.0})
    assert triggers(err_a) ^ triggers(err_b) == {(0, 501)}
    assert not flip_at_threshold(err_a, 0, 501)
    ok, readings = flip_by_suppression(err_a, err_b, 0, 501)
    assert not ok and readings == [dict(t=501, e1=[1.0, 5.0], e0=[9.0, 9.0])]


def test_suppressed_trigger_flips_with_its_marginal_predecessor():
    """A marginal firing at 501 on one side suppresses the clear trigger
    at 601 there: 601 flips far from the threshold, and only the
    suppression rule explains it."""
    err_a = metric({499: 3.99999, 599: 1.0})
    err_b = metric({499: 4.00001, 599: 1.0})
    assert triggers(err_a) == {(0, 501)}
    assert triggers(err_b) == {(0, 601)}
    assert not flip_at_threshold(err_a, 0, 601)
    ok, readings = flip_by_suppression(err_a, err_b, 0, 601)
    assert ok and [r["t"] for r in readings] == [501]
    assert flip_by_suppression(err_a, err_b, 0, 501)[0]


def test_flip_with_no_marginal_predecessor_is_rejected():
    """The same picture with the predecessor's decision a clear one, with
    the predecessor outside the window, and with no differing decision
    at all."""
    clear_a = metric({499: 1.0, 599: 1.0})
    clear_b = metric({499: 5.0, 599: 1.0})
    assert triggers(clear_a) ^ triggers(clear_b) == {(0, 501), (0, 601)}
    ok, readings = flip_by_suppression(clear_a, clear_b, 0, 601)
    assert not ok and [r["t"] for r in readings] == [501]
    # marginal, but 138 samples before: it cannot have suppressed 639
    far_a = metric({499: 3.99999, 637: 1.0})
    far_b = metric({499: 4.00001, 637: 1.0})
    ok, readings = flip_by_suppression(far_a, far_b, 0, 639)
    assert not ok and readings == []
    # one marginal and one clear difference in the window: not explained
    mixed_a = metric({499: 3.99999, 549: 1.0, 599: 1.0})
    mixed_b = metric({499: 4.00001, 549: 5.0, 599: 1.0})
    ok, readings = flip_by_suppression(mixed_a, mixed_b, 0, 601)
    assert not ok and [r["t"] for r in readings] == [501, 551]


def test_marginal_on_one_side_only_is_rejected():
    """Both sides must read within the tolerance of the threshold."""
    err_a, err_b = metric({499: 3.99999}), metric({499: 4.5})
    assert flip_at_threshold(err_a, 0, 501)
    assert not flip_at_threshold(err_b, 0, 501)
    assert not flip_by_suppression(err_a, err_b, 0, 501)[0]


def test_tolerance_is_the_sync_metrics():
    rtol, atol = ERR_TOL
    width = atol + rtol * 4.0
    inside, outside = 4.0 - 0.5 * width, 4.0 - 2.0 * width
    assert flip_at_threshold(metric({499: inside}), 0, 501)
    assert not flip_at_threshold(metric({499: outside}), 0, 501)
