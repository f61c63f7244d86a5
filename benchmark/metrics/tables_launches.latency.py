"""``tables_launches.serve`` in a cell whose end-to-end metric is the latency tail: the same
reading, moving ``frame_latency_p95_ms``."""

from benchmark.lib.spec import metric_reader

read = metric_reader("tables_launches.serve")
