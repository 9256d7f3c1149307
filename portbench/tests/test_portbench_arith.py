"""The frozen arithmetic and the metric readers, on made-up runs and a
made-up profiler trace."""

from __future__ import annotations

import statistics

import pytest

from conftest import REPO
from portbench import arith, spec
from portbench.harness import Run, Visit

MiB = 1 << 20


def reader(kind, name):
    return spec.reader(REPO, kind, name)


def test_bus_factors_are_nccl_tests():
    assert arith.bus_bytes("pl_allreduce", 1000, 8) == pytest.approx(1750)
    assert arith.bus_bytes("pl_allreduce", 1000, 4) == pytest.approx(1500)
    for op in ("pl_reduce_scatter", "pl_all_to_all"):
        assert arith.bus_bytes(op, 1000, 8) == pytest.approx(875)
    assert arith.bus_bytes("pl_hbm_copy", 1000, 1) == 2000
    assert arith.bus_bytes("pl_hbm_stream", 1000, 1) == 2000
    assert arith.bus_bytes("pl_hbm_write", 1000, 1) == 1000
    assert arith.bus_bytes("hbm_triad", 1000, 1) == 1500


def test_byte_counts_and_least_time():
    # 8 sim ranks of 256 MiB: read and write every rank's buffer once
    assert arith.memory_bytes("pl_allreduce", 256 * MiB, 8) == 4096 * MiB
    assert arith.memory_bytes("pl_hbm_write", 256 * MiB, 8) == 2048 * MiB
    assert arith.memory_bytes("hbm_triad", 256 * MiB, 1) == 384 * MiB
    assert arith.least_seconds("pl_hbm_write", 335 * 10**7, 1,
                               across_cards=False) == pytest.approx(1e-3)
    # across 4 cards the all-reduce is bound by its link bytes
    t = arith.least_seconds("pl_allreduce", 64 * MiB, 4, across_cards=True)
    assert t == pytest.approx(1.5 * 64 * MiB / 450e9)


def test_percentile_and_spread():
    xs = list(range(1, 101))
    assert arith.percentile(xs, 95) == pytest.approx(95.05)
    assert arith.percentile([3.0], 95) == 3.0
    q1, med, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert arith.quartile_spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == \
        pytest.approx((q3 - q1) / med)


def _run(visits, window_s, trace=None, traced=()):
    return Run(ranks=8, across_cards=False, window_s=window_s, setup_s=9.0,
               points_setup_s=1.5, visits=list(visits), traced=list(traced),
               trace=trace)


def test_window_rate_is_all_the_work_over_all_the_time():
    read = reader("end_to_end", "busbw_GBps")
    visits = [Visit("pl_allreduce", 16 * MiB, 32, 0.003)] * 100
    steady = read(_run(visits, 0.3))
    assert steady == pytest.approx(100 * 32 * 1.75 * 16 * MiB / 0.3 / 1e9)
    # a stall between two visits lengthens the window and lowers the rate
    assert read(_run(visits, 0.35)) < steady
    assert reader("end_to_end", "busbw_GBps.cards")(_run(visits, 0.3)) == \
        steady


def test_set_up_readers():
    visits = [Visit("pl_hbm_copy", 256 * MiB, 10, 2e-3)] * 4
    assert reader("end_to_end", "setup_s")(_run(visits, 1.0)) == 9.0
    assert reader("layer_metrics", "points_setup_s")(_run(visits, 1.0)) == 1.5


def test_a_split_metric_is_read_by_its_kind_unless_it_has_a_file(tmp_path):
    (tmp_path / "portbench" / "layer_metrics").mkdir(parents=True)
    folder = tmp_path / "portbench" / "layer_metrics"
    (folder / "idle_share.py").write_text("def read(run):\n    return 1\n")
    (folder / "idle_share.own.py").write_text("def read(run):\n    return 2\n")
    assert spec.reader(tmp_path, "layer_metrics", "idle_share.any")(None) == 1
    assert spec.reader(tmp_path, "layer_metrics", "idle_share.own")(None) == 2
    with pytest.raises(FileNotFoundError):
        spec.reader(tmp_path, "layer_metrics", "busy_share.any")


def _event(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


TRACE = [
    _event("cpu_op", "portbench.visit", 0, 400),
    _event("cuda_runtime", "cudaGraphLaunch", 10, 100),
    _event("kernel", "(anonymous namespace)::trace_gate_kernel(...)", 20, 100),
    _event("kernel", "copy_rows", 120, 180),
    _event("gpu_memcpy", "Memcpy DtoD", 300, 20),
    _event("cuda_runtime", "cudaDeviceSynchronize", 120, 210),
    _event("cpu_op", "portbench.visit", 500, 400),
    _event("kernel", "(anonymous namespace)::trace_gate_kernel(...)", 520, 100),
    _event("kernel", "copy_rows", 600, 200),
    _event("kernel", "copy_rows", 700, 50),  # overlaps: counted once
]


def test_device_summary_of_a_trace():
    s = arith.device_summary(TRACE)
    # busy: [20, 320) and [520, 800); window from 20 to 800
    assert s.busy_s == pytest.approx(580e-6)
    assert s.window_s == pytest.approx(780e-6)
    assert s.idle_share == pytest.approx(1 - 580 / 780)
    assert s.kernels["copy_rows"] == pytest.approx(430e-6)
    assert arith.name_gaps(s.gaps, TRACE) == [["between visits",
                                               pytest.approx(200e-6)]]
    late = arith.device_summary(TRACE, since=arith.first_span(
        TRACE, "portbench.visit") + 500e-6)
    assert late.busy_s == pytest.approx(280e-6)
    assert arith.device_summary([_event("cpu_op", "x", 0, 1)]) is None


def test_gap_names_follow_the_host():
    events = [_event("kernel", "k", 0, 10), _event("kernel", "k", 50, 10),
              _event("kernel", "k", 100, 10), _event("kernel", "k", 130, 10),
              _event("cpu_op", "portbench.visit", 0, 200),
              _event("cuda_runtime", "cudaGraphLaunch", 15, 30),
              _event("cuda_runtime", "cudaStreamSynchronize", 65, 30)]
    s = arith.device_summary(events)
    assert arith.name_gaps(s.gaps, events) == [
        ["dispatch", pytest.approx(40e-6)], ["fence wait", pytest.approx(40e-6)],
        ["visit", pytest.approx(20e-6)]]


def test_layer_readers_on_a_trace():
    s = arith.device_summary(TRACE)
    traced = [Visit("pl_hbm_copy", 4096, 1024, 1e-3)] * 2
    run = _run(traced, 1.0, trace=s, traced=traced)
    assert reader("layer_metrics", "idle_share.bw")(run) == \
        pytest.approx(100 * (1 - 580 / 780))
    least = 2 * 1024 * arith.memory_bytes("pl_hbm_copy", 4096, 8) / 3.35e12
    assert reader("layer_metrics", "kernels_roofline.bw")(run) == \
        pytest.approx(100 * least / 580e-6)
    # across cards the same reader of the cards' metric is bound by links
    cards = Run(ranks=4, across_cards=True, window_s=1.0, setup_s=9.0,
                points_setup_s=1.5, visits=[], trace=s,
                traced=[Visit("pl_allreduce", 64 * MiB, 8, 1e-3)])
    assert reader("layer_metrics", "kernels_roofline.cards")(cards) == \
        pytest.approx(100 * 8 * 1.5 * 64 * MiB / 450e9 / 580e-6)
    assert reader("layer_metrics", "idle_share.cards")(cards) == \
        reader("layer_metrics", "idle_share.bw")(cards)
    # a CPU run traces no device: the device readers find nothing
    bare = _run(traced, 1.0)
    for name in ("idle_share.bw", "kernels_roofline.bw",
                 "kernels_roofline.cards"):
        assert reader("layer_metrics", name)(bare) is None
