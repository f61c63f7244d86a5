"""Data parallelism of the reference copy: one process."""
