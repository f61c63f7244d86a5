"""Device operations a frame (kernels, copies, fills) that the serving thread
launched inside a table build on the card (a ``*.tables`` span: the radar
VFE's sort and compaction, the active-site backbone's tap tables). The host's
work in the table build, counted as launches: unlike ``tables_idle_ms.serve``
it does not move with the host core's speed."""

from benchmark.lib.program_spans import launches_in


def read(view):
    n = launches_in(view, ".tables")
    return None if n is None else n / view.units
