"""The metric arithmetic on synthetic windows: the busy union, each
reader's attribution of kernels to spans and threads, the shares of peak,
the breakdown, and the p95 over all frames."""

import pytest

from benchmark.lib import common, spec
from benchmark.lib.trace import (CALL_SPAN, PEAK_BF16, PEAK_BYTES, PEAK_INT8, Kernel,
                                 TraceView, breakdown, busy_us)

MAIN, AUTOGRAD = 1, 2
NS = "(anonymous namespace)::"
# kernel names as the profiler gives them, demangled (the epilogue by its
# number, ``csrc/conv3x3_wgmma.cu``'s ``Epi``) and mangled
K1_WGMMA = f"void {NS}conv_wgmma_kernel<{NS}S8, ({NS}Epi)2>(CUtensorMap, CUtensorMap, int)"
K1_CO64_BF16_OUT = f"void {NS}conv_co64_kernel<{NS}S8, ({NS}Epi)3>(CUtensorMap, int)"
K1_RESIDENT = "void conv_block_kernel<8, 3>(signed char const*, signed char const*)"
K6_CO64 = f"void {NS}conv_co64_kernel<{NS}Bf16, ({NS}Epi)4>(CUtensorMap, int)"
K6_WGMMA = f"void {NS}conv_wgmma_kernel<{NS}Bf16, ({NS}Epi)4>(CUtensorMap, int)"
K7_CO64 = f"void {NS}conv_co64_kernel<{NS}S8, ({NS}Epi)5>(CUtensorMap, int)"
K7_WGMMA_MANGLED = "_ZN12_GLOBAL__N_117conv_wgmma_kernelINS_2S8ELNS_3EpiE5EEEv14CUtensorMapS2_"
K1_WGMMA_MANGLED = "_ZN12_GLOBAL__N_117conv_wgmma_kernelINS_2S8ELNS_3EpiE2EEEv14CUtensorMapS2_"
P1_INT8 = f"void {NS}conv_wgmma_kernel<{NS}S8, ({NS}Epi)1>(CUtensorMap, int)"
K9 = f"void {NS}conv_wgmma_kernel<{NS}Bf16, ({NS}Epi)0>(CUtensorMap, int)"
STREAMED = "void conv_stream_kernel<8, 2>(signed char const*, signed char const*)"


def _view(units=2, work=None, sec=None):
    # two calls of 10 ms each on the host; kernels launched in the spans
    spans = {CALL_SPAN: [(0, 10_000, MAIN), (10_000, 20_000, MAIN)],
             "backbone_3d": [(100, 2_000, MAIN), (10_100, 12_000, MAIN)],
             "radar_cma": [(2_000, 3_000, MAIN), (12_000, 13_000, MAIN)],
             "decode_and_nms": [(3_000, 4_000, MAIN), (13_000, 14_000, MAIN)],
             "Optimizer.step#ClippedOptimizer.step": [(8_000, 9_000, MAIN),
                                                      (18_000, 19_000, MAIN)]}
    kernels = []
    for c in (0, 10_000):
        kernels += [Kernel(K1_WGMMA, c + 200, c + 1_200, c + 150, MAIN),
                    Kernel("dcn_sample_kernel", c + 2_100, c + 2_600, c + 2_050, MAIN),
                    Kernel("nms", c + 3_100, c + 3_400, c + 3_050, MAIN),
                    Kernel("dcn_input_grad", c + 5_000, c + 6_000, c + 4_900, AUTOGRAD),
                    Kernel("adam", c + 8_100, c + 8_300, c + 8_050, MAIN),
                    Kernel("overlap", c + 1_000, c + 1_500, None, None)]
    cell = {"work": work, "sec_per_unit": sec}
    return TraceView(kernels, spans, MAIN, 2, units, 20_000.0, cell)


def read(name, view):
    return spec.metric_reader(name)(view)


def test_busy_union():
    assert busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    v = _view()
    # per call: 200-1500 (1300) + 500 + 300 + 1000 + 200
    assert v.busy_us == 2 * 3300
    assert read("device_idle_pct.train", v) == pytest.approx(100 * (1 - 6600 / 20000))
    assert read("device_idle_pct.serve", v) == read("device_idle_pct.train", v)


def test_span_and_thread_attribution():
    v = _view(units=8)
    assert read("teacher_fwd_ms", v) == pytest.approx(1.0)  # per call
    assert read("radar_fwd_ms.train", v) == pytest.approx(0.5)
    assert read("radar_fwd_ms.serve", v) == pytest.approx(2 * 0.5 / 8)  # per frame
    assert read("decode_nms_ms", v) == pytest.approx(2 * 0.3 / 8)
    assert read("backward_ms", v) == pytest.approx(1.0)  # the autograd thread's
    assert read("optimizer_ms", v) == pytest.approx(0.2)


def test_shares_of_peak():
    work = {"float_flops": 2e12, "int8_ops": 1e12, "k1_ops": 1e12, "k1_bytes": 1e9}
    v = _view(units=2, work=work, sec=0.1)
    at_peak = 2e12 / PEAK_BF16 + 1e12 / PEAK_INT8
    assert read("train_mfu_pct", v) == pytest.approx(100 * at_peak / 0.1)
    assert read("serve_mfu_pct", v) == read("train_mfu_pct", v)
    k1_us = 2 * 1000  # conv_wgmma_kernel, both calls
    bound = max(1e12 / PEAK_INT8, 1e9 / PEAK_BYTES) * 2
    assert read("k1_roofline_pct", v) == pytest.approx(100 * bound / (k1_us / 1e6))


@pytest.mark.parametrize("name,k1", [
    (K1_WGMMA, True), (K1_CO64_BF16_OUT, True), (K1_RESIDENT, True), (K1_WGMMA_MANGLED, True),
    (K6_CO64, False), (K6_WGMMA, False), (K7_CO64, False), (K7_WGMMA_MANGLED, False),
    (P1_INT8, False), (K9, False), (STREAMED, False), ("dcn_sample_kernel", False)])
def test_k1_kernels_are_told_from_the_other_instantiations(name, k1):
    assert spec.metric_module("k1_roofline_pct").is_k1(name) is k1


def test_k1_roofline_counts_no_k6_or_k7_time_and_reads_nothing_on_a_shared_kernel():
    work = {"float_flops": 2e12, "int8_ops": 1e12, "k1_ops": 1e12, "k1_bytes": 1e9}
    v = _view(units=2, work=work, sec=0.1)
    alone = read("k1_roofline_pct", v)
    v.kernels += [Kernel(n, 30_000, 31_000, 9_000, MAIN) for n in (K6_CO64, K7_CO64, K6_WGMMA)]
    assert read("k1_roofline_pct", v) == alone
    v.kernels.append(Kernel(STREAMED, 31_000, 31_500, 9_000, MAIN))
    assert read("k1_roofline_pct", v) is None


def test_breakdown_lists_ops_and_idle_gaps():
    b = breakdown(_view())
    assert b["device_ops"][0] == [K1_WGMMA[:120], pytest.approx(2e-3)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    gaps = dict(b["idle_gaps"])
    assert gaps["backbone_3d"] == pytest.approx(2 * 600e-6)  # 1500 -> 2100
    # between the first kernel (at 200) and the last (ending at 18 300)
    assert sum(gaps.values()) == pytest.approx((18_300 - 200 - 6600) / 1e6)


def test_p95_over_all_frames():
    lat = list(range(1, 201))
    assert common.p95(lat) == pytest.approx(190.95)
