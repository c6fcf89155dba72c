"""The window's rule: whole batches, ending with the first one that ends
at or after the window's length; a rate over all of its time."""

import pytest

from gpubench import traffic


class FakeClock:
    def __init__(self, durations):
        self.now, self.durations = 0.0, list(durations)

    def step(self, i):
        self.now += self.durations[i]

    def __call__(self):
        return self.now


@pytest.mark.parametrize("durations,seconds,want_n,want_s", [
    ([1.0] * 10, 3.0, 3, 3.0),          # ends exactly at the length
    ([1.5] * 10, 3.0, 2, 3.0),
    ([1.2] * 10, 3.0, 3, 3.6),          # the batch that crosses the length counts
    ([5.0, 1.0], 3.0, 1, 5.0),          # one long batch
    ([0.5, 0.5, 4.0, 1.0], 2.0, 3, 5.0),
])
def test_window_runs_whole_steps_until_the_length(durations, seconds, want_n, want_s):
    clock = FakeClock(durations)
    n, s = traffic.run_window(clock.step, seconds, clock)
    assert (n, s) == (want_n, pytest.approx(want_s))


def test_batch_lengths_are_the_same_set_for_every_seed():
    import numpy as np

    a = traffic.batch_lengths(np.random.default_rng(1), 24, 100, 128)
    b = traffic.batch_lengths(np.random.default_rng(2), 24, 100, 128)
    assert sorted(a) == sorted(b) and min(a) == 100 and max(a) == 128


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    from gpubench.trace import OUTSIDE, gaps, labels_at

    spans = [("step", 0, 100), ("forward", 10, 40), ("top_k", 50, 60)]
    times = [5, 15, 45, 55, 120]
    assert labels_at(spans, times) == ["step", "forward", "step", "top_k", OUTSIDE]
    assert gaps([(0, 10), (5, 20), (30, 40)], 0, 50) == [(20, 30), (40, 50)]
