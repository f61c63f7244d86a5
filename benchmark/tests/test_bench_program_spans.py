"""The readers of the program's inner spans on synthetic windows: kernels
launched on autograd's thread inside the ``<stage>.backward`` spans, the
losses on the step's thread, the idle gaps labelled ``*.tables`` against a
sum made by hand and the launches inside those spans against a count made by
hand, and the NMS's IoU time and rounds a frame. A program
without the spans (the parent of the change that added them) reads None."""

import pytest

from benchmark.lib import spec
from benchmark.lib.trace import CALL_SPAN, Kernel, TraceView

MAIN, AUTOGRAD = 1, 2


def read(name, view):
    return spec.metric_reader(name)(view)


def _train_view(with_inner=True):
    # two steps of 10 ms on the host; the backward on autograd's thread from
    # 5 ms to 8 ms of each, its stages' spans tiling it
    spans = {CALL_SPAN: [], "radar_backbone_3d": [], "assign_targets": [], "backward": []}
    inner = {"radar_backbone_3d.tables": [], "losses": [], "losses.head": [],
             "losses.backward": [], "radar_dense_head.backward": [],
             "radar_neck.backward": [], "radar_cma.backward": [],
             "radar_backbone_3d.backward": [], "radar_vfe.backward": []}
    kernels = []
    for c in (0, 10_000):
        spans[CALL_SPAN].append((c, c + 10_000, MAIN))
        spans["radar_backbone_3d"].append((c + 1_000, c + 3_000, MAIN))
        inner["radar_backbone_3d.tables"].append((c + 1_005, c + 2_000, MAIN))
        spans["assign_targets"].append((c + 3_000, c + 3_500, MAIN))
        inner["losses"].append((c + 3_500, c + 4_500, MAIN))
        inner["losses.head"].append((c + 3_500, c + 4_000, MAIN))
        spans["backward"].append((c + 5_000, c + 8_000, MAIN))
        for i, n in enumerate(("losses", "radar_dense_head", "radar_neck", "radar_cma",
                               "radar_backbone_3d", "radar_vfe")):
            inner[f"{n}.backward"].append((c + 5_000 + 500 * i, c + 5_500 + 500 * i, AUTOGRAD))
        kernels += [
            # the table build leaves the card idle from 1.1 to 1.9 ms
            Kernel("sort", c + 1_000, c + 1_100, c + 1_010, MAIN),
            Kernel("compact", c + 1_900, c + 2_100, c + 1_020, MAIN),
            Kernel("conv", c + 2_100, c + 3_000, c + 2_050, MAIN),
            Kernel("targets", c + 3_000, c + 3_100, c + 3_010, MAIN),
            Kernel("focal", c + 3_600, c + 3_800, c + 3_600, MAIN),
            Kernel("distill", c + 3_900, c + 4_000, c + 4_600, MAIN),
            # the backward: one kernel a stage, 100 us each, stage i 10 * (i + 1) us more
            *[Kernel(f"bwd{i}", c + 5_010 + 500 * i, c + 5_110 + 500 * i + 10 * (i + 1),
                     c + 5_005 + 500 * i, AUTOGRAD) for i in range(6)],
            # launched by the step's thread while the CMA's backward was open
            # there: not the CMA's
            Kernel("main_thread", c + 6_600, c + 6_610, c + 6_510, MAIN),
        ]
    if with_inner:
        spans.update(inner)
    return TraceView(kernels, spans, MAIN, 2, 16, 20_000.0, {})


def test_backward_readers_take_autograd_threads_kernels_a_step():
    v = _train_view()
    # stages 0 losses, 1 head, 2 neck, 3 cma, 4 backbone, 5 vfe
    us = [100 + 10 * (i + 1) for i in range(6)]
    assert read("cma_bwd_ms", v) == pytest.approx(us[3] / 1e3)
    assert read("backbone_bwd_ms", v) == pytest.approx((us[4] + us[5]) / 1e3)
    assert read("head_bwd_ms", v) == pytest.approx((us[0] + us[1] + us[2]) / 1e3)
    total = sum(read(m, v) for m in ("cma_bwd_ms", "backbone_bwd_ms", "head_bwd_ms"))
    assert total == pytest.approx(read("backward_ms", v))


def test_losses_ms_takes_targets_and_losses_on_the_steps_thread():
    # targets 100 us, focal 200 us; distill launched after the span closed
    assert read("losses_ms", _train_view()) == pytest.approx(0.3)


def test_tables_idle_is_the_gaps_the_breakdown_labels_tables():
    v = _train_view()
    # a gap opens at 1.1 ms inside radar_backbone_3d.tables and lasts to 1.9
    # ms; later gaps open outside any *.tables span
    assert read("tables_idle_ms.train", v) == pytest.approx(0.8)
    v.units = 4
    assert read("tables_idle_ms.serve", v) == pytest.approx(2 * 0.8 / 4)  # a frame
    assert read("tables_idle_ms.latency", v) == read("tables_idle_ms.serve", v)


def test_tables_idle_reads_zero_where_the_tables_leave_no_gap():
    v = _train_view()
    v.kernels.append(Kernel("fill", 1_100, 1_900, 1_030, MAIN))
    v.kernels.append(Kernel("fill", 11_100, 11_900, 11_030, MAIN))
    assert read("tables_idle_ms.train", v) == 0.0


def test_tables_launches_count_the_steps_threads_launches_inside_the_spans():
    v = _train_view()
    # sort and compact a step: conv launched after the span closed; the
    # autograd thread launches nothing in the step's spans
    assert read("tables_launches.train", v) == 2
    v.units = 4
    assert read("tables_launches.serve", v) == pytest.approx(2 * 2 / 4)  # a frame
    assert read("tables_launches.latency", v) == read("tables_launches.serve", v)
    # a launch from another thread inside the span's time is not the span's
    v.kernels.append(Kernel("other", 1_500, 1_600, 1_500, AUTOGRAD))
    # two spans of the kind that overlap count a launch once
    v.spans["vfe.tables"] = [(1_000, 1_015, MAIN)]
    assert read("tables_launches.train", v) == 2
    # the count does not follow the host's speed: the same launches, the
    # compaction's launched later and the card idle longer, read the same
    slow = _train_view()
    for k in slow.kernels:
        if k.name == "compact":
            k.launch, k.start, k.end = k.launch + 970, k.start + 800, k.end + 800
    assert read("tables_launches.train", slow) == 2
    assert read("tables_idle_ms.train", slow) > read("tables_idle_ms.train", _train_view())


def _serve_view():
    # two calls of two frames: in each, two heads, NMS rounds 2 and 3, the IoU
    # 300 us of kernels a head
    spans = {CALL_SPAN: [], "decode_and_nms": [], "decode_and_nms.iou": [],
             "decode_and_nms.round": []}
    kernels = []
    for c in (0, 10_000):
        spans[CALL_SPAN].append((c, c + 10_000, MAIN))
        spans["decode_and_nms"].append((c + 1_000, c + 9_000, MAIN))
        for h, t in enumerate((c + 1_000, c + 5_000)):
            spans["decode_and_nms.iou"].append((t, t + 1_000, MAIN))
            kernels.append(Kernel("cumsum", t + 100, t + 400, t + 50, MAIN))
            spans["decode_and_nms.round"] += [(t + 1_000 + 500 * r, t + 1_400 + 500 * r, MAIN)
                                              for r in range(2 + h)]
        kernels.append(Kernel("outside", c + 9_100, c + 9_900, c + 9_050, MAIN))
    return TraceView(kernels, spans, MAIN, 2, 4, 20_000.0, {})


def test_nms_readers_a_frame():
    v = _serve_view()
    assert read("nms_iou_ms", v) == pytest.approx(4 * 0.3 / 4)
    assert read("nms_rounds", v) == pytest.approx(2 * (2 + 3) / 4)
    assert read("nms_iou_ms.latency", v) == read("nms_iou_ms", v)
    assert read("nms_rounds.latency", v) == read("nms_rounds", v)


NEW = ("losses_ms", "cma_bwd_ms", "backbone_bwd_ms", "head_bwd_ms", "tables_idle_ms.train",
       "tables_idle_ms.serve", "tables_idle_ms.latency", "nms_iou_ms", "nms_iou_ms.latency",
       "nms_rounds", "nms_rounds.latency", "tables_launches.train", "tables_launches.serve",
       "tables_launches.latency")


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_spans_reads_none(metric):
    assert read(metric, _train_view(with_inner=False)) is None
    if "nms" in metric:
        v = _serve_view()
        del v.spans["decode_and_nms.iou"], v.spans["decode_and_nms.round"]
        assert read(metric, v) is None


def test_every_new_reader_is_in_the_benchmark():
    names = {m["name"] for m in spec.bench_spec()["per_layer"]}
    assert set(NEW) <= names
