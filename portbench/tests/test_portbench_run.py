"""A whole run of the harness on the CPU at a tiny size (the port's plain
versions in place of the kernels), past the look for a card: the clean
run comes out correct; the control and each fault that a one-chip GG20
cell can have (portbench/faults.py) come out not correct."""

import itertools

from portbench import control, faults, harness


def passes(n):
    """The window's clock that counts passes: exactly n passes."""
    return dict(seconds=n - 0.5, clock=itertools.count().__next__)


def test_clean_run_is_correct(tiny_spec):
    result, checks = harness.run_cell(tiny_spec, 11, trace=1, device="cpu", **passes(2))
    assert result["correct"], checks
    assert result["attempted"] == 8 and result["failed"] == 0
    assert set(checks) == set(result["checks"]) and list(result)[-1] == "checks"
    m = result["metrics"]
    assert {"offline_s", "online_s", "gate_s"} <= set(m)
    # on the CPU no kernel launches: nothing read, nothing reported
    assert "k1_roofline" not in m and "device_idle" not in m


def test_control_is_not_correct(tiny_spec):
    result, checks = harness.run_cell(tiny_spec, 12, trace=0, device="cpu",
                                      program_cls=control.Program, **passes(2))
    assert not result["correct"]
    assert checks["high_s"] > 0 and checks["sig_bad"] == 0 and checks["key_wrong"] == 0


def test_state_returned_unchanged_is_not_correct(tiny_spec):
    result, checks = faults.run_with(tiny_spec, 13, "stale", device="cpu")
    assert not result["correct"] and checks["r_repeats"] == 4


def test_half_the_batch_left_out_is_not_correct(tiny_spec):
    result, checks = faults.run_with(tiny_spec, 14, "half", device="cpu")
    assert not result["correct"] and checks["missing"] == 4


def test_an_answer_altered_is_not_correct(tiny_spec):
    result, checks = faults.run_with(tiny_spec, 15, "altered", device="cpu")
    assert not result["correct"]
    assert checks["sig_bad"] == 2 and checks["mask_wrong"] == 2
