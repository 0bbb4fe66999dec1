"""The window's arithmetic on a fake clock, and the messages drawn from
the seed."""

from portbench import harness


class FakeClock:
    """A clock that moves only when a pass runs: each pass takes the next
    of `durations` seconds."""

    def __init__(self, durations):
        self.t, self.durations = 100.0, list(durations)

    def __call__(self):
        return self.t

    def pass_(self, i):
        self.t += self.durations[i]
        return i


def test_passes_start_until_the_seconds_have_elapsed_and_none_is_cut():
    clock = FakeClock([3.0] * 10)
    outs, t0, t1 = harness.run_window(clock.pass_, 10.0, clock)
    # passes end at 3, 6, 9, 12 s: the fourth starts at 9 s < 10 s and runs whole
    assert outs == [0, 1, 2, 3] and t0 == 100.0 and t1 == 112.0
    sig_per_s = len(outs) * 4096 / (t1 - t0)
    assert sig_per_s == 4 * 4096 / 12


def test_the_window_overruns_by_at_most_one_pass():
    clock = FakeClock([2.0, 9.0, 1.0, 1.0])
    outs, t0, t1 = harness.run_window(clock.pass_, 10.0, clock)
    assert outs == [0, 1] and t1 - t0 == 11.0


def test_one_pass_at_least():
    clock = FakeClock([5.0])
    outs, t0, t1 = harness.run_window(clock.pass_, 0.001, clock)
    assert outs == [0] and t1 - t0 == 5.0


def test_messages_are_distinct_and_drawn_from_the_seed():
    a, b = harness.Messages(2**31 + 77), harness.Messages(2**31 + 77)
    first = a.draw(4096) + a.draw(4096)
    assert first == b.draw(4096) + b.draw(4096)
    assert len(set(first)) == 8192 and all(0 <= m < 2**256 for m in first)
    assert harness.Messages(2**31 + 78).draw(8) != first[:8]
