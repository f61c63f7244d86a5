"""Ms a step in which the card was idle while the step's thread was inside a
table build on the card (a ``*.tables`` span: the VFEs' sort and compaction,
the active-site backbone's tap tables, the teacher's masks): the idle gaps
that the breakdown labels ``*.tables``, summed."""

from benchmark.lib.program_spans import idle_us_labelled


def read(view):
    us = idle_us_labelled(view, ".tables")
    return None if us is None else us / 1e3 / view.calls
