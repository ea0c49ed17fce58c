"""The end-to-end arithmetic on synthetic spans: a stall inside the
window moves both the rate and the tail."""

import pytest

from benchmark import stats


def _closed_loop(n, each, stall_every=0, stall=0.0):
    """(start, finish) of ``n`` requests one after another, every
    ``stall_every``-th held ``stall`` seconds longer."""
    t, spans = 100.0, []
    for i in range(n):
        took = each + (stall if stall_every and i % stall_every == 0 else 0.0)
        spans.append((t, t + took))
        t += took
    return spans


def test_rate_is_all_work_over_all_time():
    done = [10.0 + 0.1 * (i + 1) for i in range(50)]
    assert stats.rate(done, 10.0, 128) == pytest.approx(50 * 128 / 5.0)


def test_stall_moves_rate_and_tail():
    steady = _closed_loop(200, 0.004)
    stalled = _closed_loop(200, 0.004, stall_every=10, stall=0.05)  # 20 of 200 held 50 ms
    assert stats.latency_ms(steady, 95) == pytest.approx(4.0)
    assert stats.latency_ms(stalled, 95) > 40.0
    assert stats.latency_ms(stalled, 50) == pytest.approx(4.0)
    rate = stats.rate([b for _, b in steady], 100.0, 1)
    assert rate == pytest.approx(250.0)
    assert stats.rate([b for _, b in stalled], 100.0, 1) < 0.5 * rate


def test_percentiles_over_every_request():
    spans = [(0.0, x / 1e3) for x in range(1, 101)]
    assert stats.latency_ms(spans, 50) == pytest.approx(50.5)
    assert stats.latency_ms(spans, 95) == pytest.approx(95.05)
