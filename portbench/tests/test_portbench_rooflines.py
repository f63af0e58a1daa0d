"""The copied roofline arithmetic gives PERF.md's recorded bounds."""

import pytest

from portbench import rooflines

H100 = rooflines.peaks("NVIDIA H100 80GB HBM3")


def test_argkmin_bound_main_path():
    # (C, D, M, TK) = (131072, 16, 8192, 13), 92,118 valid rows: 0.3604 ms
    s, by = rooflines.argkmin_bound_s(8192, 92118, 131072, 16, 13, H100)
    assert by == "operations"
    assert s * 1e3 == pytest.approx(0.3604, abs=5e-5)


def test_sweep_bound_main_path():
    # (U, K) = (107200, 24), mean frontier 35,169.4 rows over 459 sweeps: 2.42 us
    s, by = rooflines.sweep_bound_s(107200, 24, 107200, 35169.4, H100)
    assert by == "bytes"
    assert s * 1e6 == pytest.approx(2.42, abs=5e-3)
    # the first sweep of that solve, 47,992 rows: 3.19 us
    assert rooflines.sweep_bound_s(107200, 24, 107200, 47992, H100)[0] * 1e6 == pytest.approx(
        3.19, abs=5e-3)


def test_unknown_card_has_no_peaks():
    assert rooflines.peaks("cpu") is None
