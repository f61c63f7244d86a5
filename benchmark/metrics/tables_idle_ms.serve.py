"""Ms a frame in which the card was idle while the serving thread was inside a
table build on the card (a ``*.tables`` span: the radar VFE's sort and
compaction, the active-site backbone's tap tables): the idle gaps that the
breakdown labels ``*.tables``, summed."""

from benchmark.lib.program_spans import idle_us_labelled


def read(view):
    us = idle_us_labelled(view, ".tables")
    return None if us is None else us / 1e3 / view.units
