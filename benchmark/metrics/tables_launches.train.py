"""Device operations a step (kernels, copies, fills) that the step's thread
launched inside a table build on the card (a ``*.tables`` span: the VFEs'
sort and compaction, the active-site backbone's tap tables, the teacher's
masks). The host's work in the table build, counted as launches: unlike
``tables_idle_ms.train`` it does not move with the host core's speed."""

from benchmark.lib.program_spans import launches_in


def read(view):
    n = launches_in(view, ".tables")
    return None if n is None else n / view.calls
