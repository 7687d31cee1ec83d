"""The roofline arithmetic against counts worked by hand, and the trace's
reduction on synthetic records: the device span, the idle share, and a
kernel's time a call as its mean a launch times its counted launches,
which a trace that lost a prefix of its events reads the same."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from gpabench.harness import bench, roofline, trace  # noqa: E402


def test_grouped_sweep_work_by_hand():
    # one image, G 1, P 2, H 1, n 4, m 8, W0 2, Wb 3:
    # stage 1 8 * 2 * 4 * 2 * 3 = 384, stage 2 8 * 2 * 4 * 8 * 3 = 1536
    ops, nbytes = roofline.grouped_sweep_work(1, 1, 2, 1, 4, 8, 2, 3)
    assert ops == 384 + 1536
    # windows 2 * 1 * 2 * 3, gx + gy 2 * (2 + 3), A0 2 * 4 * 2,
    # A1 2 * 8 * 3, outputs 5 * 4 * 8 floats
    assert nbytes == 4 * (12 + 10 + 16 + 48 + 160)


def test_bench_sweep_bound():
    # the bench extractor's plan (G 3, P 36, H 1, W0 192, Wb 128) at 4096^2:
    # 8 * 108 * 4096 * 128 * (192 + 4096) flops at 495 TFLOP/s
    ops, nbytes = roofline.grouped_sweep_work(1, 3, 36, 1, 4096, 4096, 192,
                                              128)
    assert ops == pytest.approx(8 * 108 * 4096 * 128 * 4288)
    ms = roofline.tensor_core_bound_ms(ops, nbytes)
    assert ms == pytest.approx(ops / 495e12 * 1e3)
    assert 3.9 < ms < 4.0


def test_frozen_bounds():
    assert roofline.bound(3.35e9, 0) == (1.0, "bytes")
    assert roofline.bound(0, 67e9) == (1.0, "operations")
    fp32, tc = roofline.zoom_bounds(0, 67e9, 495e9)
    assert fp32 == pytest.approx(1e3 * (67e9 + 495e9) / 67e12)
    assert tc == pytest.approx(1.0 + 3.0)
    assert roofline.chain_bytes(1, 2, 2) == (9 + 4 + 6) * 16 + 2 * 16
    assert roofline.dct_ops(8, 2) == 2.5 * 8 * 3 * 2


def test_kernel_base_names():
    assert trace.kernel_base("void grouped_stage2_kernel<false>(float "
                             "const*, int)") == "grouped_stage2_kernel"
    assert trace.kernel_base("void ns::stage1_kernel(float*)") == \
        "stage1_kernel"
    assert trace.kernel_base("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD"


def records(prefix_lost=0):
    """Three calls of stage1 (2 ms), grouped_stage2 (10 ms), uv (1 ms),
    split_basis (0.5 ms) with 1 ms gaps between calls; the first
    `prefix_lost` records dropped."""
    recs, t = [], 0
    for _ in range(3):
        for name, ms in (("void split_basis_kernel(float*)", 0.5),
                         ("void stage1_kernel(float*)", 2.0),
                         ("void grouped_stage2_kernel<false>(float*)", 10.0),
                         ("void uv_kernel(float*)", 1.0)):
            recs.append((name, t, t + int(ms * 1e6)))
            t += int(ms * 1e6)
        t += int(1e6)
    return recs[prefix_lost:]


def test_busy_span_and_idle():
    busy, span = trace.busy_and_span(records())
    assert busy == pytest.approx(3 * 13.5e-3)
    assert span == pytest.approx(3 * 13.5e-3 + 2e-3)
    read = bench.metric_reader("idle_pct")
    run = type("R", (), {"trace": (records(), [])})()
    assert read(run) == pytest.approx(100 * 2e-3 / (3 * 13.5e-3 + 2e-3))
    gaps = trace.idle_gaps(records(), [("read", 0, int(1e9))])
    assert gaps == [["read", pytest.approx(2e-3)]]


@pytest.mark.parametrize("lost", [0, 1, 5])
def test_roofline_reads_mean_times_counted_launches(lost):
    read = bench.metric_reader("sweep_roofline_pct")
    run = type("R", (), {})()
    run.trace = (records(lost), [])
    run.launches = {"sweep_uv": 1.0, "split_basis": 1.0}
    run.plan = (3, 36, 1, 192, 128)
    run.shape = (4096, 4096)
    run.batch = 1
    ops, nbytes = roofline.grouped_sweep_work(1, 3, 36, 1, 4096, 4096, 192,
                                              128)
    want = 100 * roofline.tensor_core_bound_ms(ops, nbytes) / 13.5
    assert read(run) == pytest.approx(want)


def test_roofline_silent_without_its_kernels():
    read = bench.metric_reader("sweep_roofline_pct")
    run = type("R", (), {})()
    run.trace = ([("void dct_kernel(float*)", 0, 1000)], [])
    run.launches = {"sweep_uv": 1.0}
    run.plan = (3, 36, 1, 192, 128)
    run.shape = (4096, 4096)
    run.batch = 1
    assert read(run) is None
    run.trace = None
    assert read(run) is None
