"""Device ms a frame of the kernels launched inside the ``decode_and_nms.iou``
span (the candidates' BEV IoU: the polygon clipping of ``ops/geometry.py``)
on the serving thread."""


def read(view):
    spans = [s for s in view.spans_named("decode_and_nms.iou") if s[2] == view.main_thread]
    if not spans:
        return None
    return view.kernel_us_launched_in(spans, view.main_thread) / 1e3 / view.units
