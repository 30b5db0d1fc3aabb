"""The kernels' work on hand-counted shapes."""
import pytest

from aqpbench.roofline import work


def test_poisson_bootstrap_work():
    # 4 groups x 1024 slots, B = 300, 3000 live rows, a bool gate:
    # flops 3000 * 300 * 11; bytes 4*1024*8 + 4*(8+1) + 4*300*5*4.
    f, b = work.poisson_bootstrap(4, 1024, 300, 3000, gate_bytes=1)
    assert f == 3000 * 300 * 11
    assert b == 32768 + 36 + 24000


def test_segment_boot_work():
    # 9000 elements in 9 lanes, B = 300, 8000 live: 7 flops a pair;
    # bytes 9000 * 20 + 10 * 8 + 9 * 300 * 3 * 4.
    f, b = work.segment_boot(9000, 9, 300, 8000)
    assert f == 8000 * 300 * 7
    assert b == 180000 + 80 + 32400


def test_least_seconds_takes_the_larger_term():
    assert work.least_seconds(6.7e13, 1.0) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)
