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


def test_least_seconds_by_peak():
    # The default peak is f32's, so rows 1 and 2 read as before; the bf16
    # tensor-core rate is the data sheet's dense 989.4 TFLOP/s.
    assert work.PEAKS["bf16_tensor_flops_per_s"] == 9.894e14
    assert work.least_seconds(6.7e13, 1.0) == work.least_seconds(
        6.7e13, 1.0, peak="fp32_flops_per_s") == 1.0
    assert work.least_seconds(9.894e14, 1.0, peak="bf16_tensor_flops_per_s") \
        == pytest.approx(1.0)
    assert work.least_seconds(9.894e14, 3.35e12,
                              peak="bf16_tensor_flops_per_s") \
        == pytest.approx(1.0)
    assert work.least_seconds(1.0, 3.35e13,
                              peak="bf16_tensor_flops_per_s") \
        == pytest.approx(10.0)


@pytest.mark.parametrize("record,want", [
    ((4, 1024, 300, 1, 3000), work.poisson_bootstrap(4, 1024, 300, 3000, 1)),
    ((0, 1024, 300, 0, 0), (0.0, 0.0)),
    ((4, 0, 300, 0, 0), (0.0, 0.0))])
def test_poisson_bootstrap_record(record, want):
    assert work.poisson_bootstrap_record(record) == want


@pytest.mark.parametrize("record,want", [
    ((9000, 9, 300, 8000), work.segment_boot(9000, 9, 300, 8000)),
    ((0, 9, 300, 0), (0.0, 0.0)),
    ((9000, 0, 300, 0), (0.0, 0.0))])
def test_segment_boot_record(record, want):
    assert work.segment_boot_record(record) == want


def _trace(names, durations_ns):
    import numpy as np
    from aqpbench.devtrace import DeviceTrace
    start = np.arange(len(names), dtype=np.int64) * 10_000
    return DeviceTrace(list(names), start,
                       start + np.asarray(durations_ns, np.int64), [],
                       (0, 10_000 * len(names)))


def test_roofline_reads_each_entry_by_its_work_and_peak():
    """Rows 1 and 2's readers through the shared entries (the number the
    branch on the kernel's name gave), and a kind's entry with its own
    peak through its device-op names."""
    from types import SimpleNamespace

    import torch

    from aqpbench import kernels
    from aqpbench.cell import reader
    from aqpbench.metrics_common import roofline

    toy = kernels.Kernel(site=None, record=None, launches=None,
                         events=("toy_gemm",),
                         work=lambda r: (r[0] * r[1], 0.0),
                         peak="bf16_tensor_flops_per_s")
    calls = {"poisson_bootstrap": [(4, 1024, 300, 1, torch.tensor(3000)),
                                   (0, 1024, 300, 0, torch.tensor(0))],
             "segment_boot": [(9000, 9, 300, torch.tensor(8000))],
             "toy": [(2.0, torch.tensor(4_947)), (3.0, torch.tensor(0))]}
    tracer = SimpleNamespace(
        kernels={**kernels.SHARED, "toy": toy}, calls=calls,
        launches={"poisson_bootstrap": 2, "segment_boot": 1, "toy": 2})
    tr = _trace(["pb_kernel", "pb_kernel", "seg_plan_kernel",
                 "seg_boot_kernel", "toy_gemm", "toy_gemm"],
                [4000, 6000, 1000, 3000, 10, 10])
    run = {"trace": tr, "tracer": tracer}
    pb = work.least_seconds(*work.poisson_bootstrap(4, 1024, 300, 3000, 1))
    seg = work.least_seconds(*work.segment_boot(9000, 9, 300, 8000))
    assert reader("kernel.poisson_bootstrap_roofline")(run) \
        == pytest.approx(100.0 * pb / 10e-6, rel=1e-12)
    assert reader("kernel.segment_boot_roofline")(run) \
        == pytest.approx(100.0 * seg / 4e-6, rel=1e-12)
    assert roofline(run, "toy") == pytest.approx(
        100.0 * 2.0 * 4_947 / 9.894e14 / 20e-9)
    # Another number of launches than the profiler saw: nothing to read.
    tracer.launches["toy"] = 3
    assert roofline(run, "toy") is None
    assert roofline(run, "absent") is None
