"""Rounds a frame of the NMS fixed point (``ops/nms.py::class_agnostic_nms``),
each ending in a host synchronization: the ``decode_and_nms.round`` spans on
the serving thread, counted."""


def read(view):
    rounds = sum(1 for s in view.spans_named("decode_and_nms.round") if s[2] == view.main_thread)
    return rounds / view.units if rounds else None
