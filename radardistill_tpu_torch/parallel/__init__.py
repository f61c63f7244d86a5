"""Data parallelism of the port over ``torch.distributed``."""

from .mesh import Mesh, make_mesh, shard_batch, wrap_ddp  # noqa: F401
