"""XLA's cost analysis of the JAX package's val eval step: the figures that
``tools/test.py --cal_params`` logs (parameters, flops, bytes accessed), on
the batch the port's ``data/synthetic.py::make_batch`` builds for
``radar_distill_val.yaml`` (one scene, 3000 radar returns, 40 boxes, 8192
radar slots, its lidar points dropped), with the model in float32.

    JAX_PLATFORMS=cpu python tools/xla_cost_reference.py [--grid 256] [--scatter_compaction]

The step is traced and compiled, never run. ``--grid`` rescales the range at
the shipped voxel size (``production_cfg``); without it the grid is the
shipped 1440², whose compile takes several GiB of host memory.
``--scatter_compaction`` compiles the step with the decode's polygon
compaction (``ops/geometry.py::_clip_halfplane_batched``) written as the
PyTorch port writes it, a scatter of the kept vertices instead of a masked
sum over a (16, 8) one-hot: the same function with less work, the figure
``tests/test_torch_cost.py`` holds the port's count to. The package itself is
unchanged; the function is swapped for the compile only. Beside the step it
prints XLA's count of the step's NMS alone (``decode_nms_cost``: six heads of
500 candidates), the part of the step that the port's NMS kernels replace.
"""

import argparse
import contextlib
import copy
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def clip_halfplane_scatter(verts, n_valid, p0, p1):
    """``_clip_halfplane_batched`` with the port's compaction: each kept
    candidate scattered to its slot, the rest to a dump slot that is cut
    off."""
    import jax.numpy as jnp

    from radardistill_tpu.ops.geometry import _MAX_VERTS

    ex = (p1 - p0)[..., None, :]
    d = ex[..., 0] * (verts[..., 1] - p0[..., None, 1]) - ex[..., 1] * (
        verts[..., 0] - p0[..., None, 0])
    idx = jnp.arange(_MAX_VERTS)
    is_last = idx == (n_valid[..., None] - 1)
    nxt_d = jnp.where(is_last, d[..., 0:1], jnp.roll(d, -1, axis=-1))
    nxt_v = jnp.where(is_last[..., None], verts[..., 0:1, :], jnp.roll(verts, -1, axis=-2))
    valid = idx < n_valid[..., None]
    inside, nxt_inside = d >= 0, nxt_d >= 0
    denom = d - nxt_d
    t = d / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    inter = verts + t[..., None] * (nxt_v - verts)
    emit_v = inside & valid
    emit_i = (inside != nxt_inside) & valid
    lead = verts.shape[:-2]
    out_pts = jnp.stack([verts, inter], axis=-2).reshape(*lead, 16, 2)
    out_keep = jnp.stack([emit_v, emit_i], axis=-1).reshape(*lead, 16)
    pos = jnp.cumsum(out_keep.astype(jnp.int32), axis=-1) - 1
    dst = jnp.where(out_keep & (pos < _MAX_VERTS), pos, _MAX_VERTS)
    out = jnp.put_along_axis(jnp.zeros((*lead, _MAX_VERTS + 1, 2), verts.dtype),
                             jnp.broadcast_to(dst[..., None], (*lead, 16, 2)), out_pts,
                             axis=-2, inplace=False)
    n_out = jnp.minimum(jnp.sum(out_keep, axis=-1), _MAX_VERTS).astype(jnp.int32)
    return out[..., :_MAX_VERTS, :], n_out


@contextlib.contextmanager
def _swapped(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def val_step_cost(grid=None, scatter_compaction=False):
    """{"flops", "bytes_accessed", "params"} of XLA's compile of the JAX val
    eval step (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import radardistill_tpu.ops.geometry as geometry
    from radardistill_tpu.data.collate import collate_batch
    from radardistill_tpu.data.host_precompute import HostPrecompute
    from radardistill_tpu.data.synthetic import make_scene
    from radardistill_tpu.models import build_network
    from radardistill_tpu.train.train_step import make_eval_step
    from radardistill_tpu.utils.production import VAL_YAML, production_cfg

    full, info = production_cfg(VAL_YAML, grid=grid)
    scene = make_scene(0, num_lidar=100, num_radar=3000, num_boxes=40,
                       pc_range=info["point_cloud_range"])
    del scene["points"]
    batch = collate_batch([scene], {"MAX_RADAR_POINTS": 8192, "NUM_MAX_OBJS": 500})
    batch.pop("_host", None)
    geo = (info["grid_size"], info["voxel_size"], info["point_cloud_range"])
    jbatch = jax.tree.map(jnp.asarray, HostPrecompute(full.MODEL, *geo)(copy.deepcopy(batch)))
    model = build_network(full.MODEL, info, compute_dtype=jnp.float32)
    # the variables' shapes: train mode's tree is eval mode's, traced without the decode
    shapes = jax.eval_shape(lambda k, b: model.init(k, b, True), jax.random.PRNGKey(0), jbatch)
    swap = (_swapped(geometry, "_clip_halfplane_batched", clip_halfplane_scatter)
            if scatter_compaction else contextlib.nullcontext())
    with swap:
        lowered = jax.jit(make_eval_step(model)).lower(shapes["params"], shapes["batch_stats"],
                                                       jbatch)
    ca = lowered.compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    return {"flops": ca["flops"], "bytes_accessed": ca["bytes accessed"],
            "params": sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))}


def decode_nms_cost(scatter_compaction=False, heads=6, k=500, post_max=83, nms_thresh=0.2):
    """XLA's flops of the JAX decode's NMS alone, as the val step runs it:
    ``heads`` calls of ``ops/nms.py::class_agnostic_nms`` over one sample's
    ``k`` candidates (``MAX_OBJ_PER_SAMPLE`` 500 of ``radar_distill_val.yaml``,
    ``NMS_POST_MAXSIZE`` 83, ``NMS_THRESH`` 0.2), each vmapped over the batch
    of 1; ``scatter_compaction`` as in ``val_step_cost``."""
    import functools

    import jax
    import jax.numpy as jnp

    import radardistill_tpu.ops.geometry as geometry
    from radardistill_tpu.ops.nms import class_agnostic_nms

    fn = jax.vmap(functools.partial(class_agnostic_nms, nms_thresh=nms_thresh, pre_max=k,
                                    post_max=post_max))
    args = (jax.ShapeDtypeStruct((1, k, 9), jnp.float32),
            jax.ShapeDtypeStruct((1, k), jnp.float32), jax.ShapeDtypeStruct((1, k), jnp.bool_))
    swap = (_swapped(geometry, "_clip_halfplane_batched", clip_halfplane_scatter)
            if scatter_compaction else contextlib.nullcontext())
    with swap:
        lowered = jax.jit(fn).lower(*args)
    ca = lowered.compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    return heads * ca["flops"]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid", type=int, default=None)
    parser.add_argument("--scatter_compaction", action="store_true")
    args = parser.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    c = val_step_cost(args.grid, args.scatter_compaction)
    c["nms_flops"] = decode_nms_cost(args.scatter_compaction)
    print(f"XLA val eval step, grid {args.grid or 1440}, bs1, float32"
          f"{', the port compaction' if args.scatter_compaction else ''}: params {c['params']}, "
          f"flops {c['flops']:.0f}, bytes accessed {c['bytes_accessed']:.0f}; the decode's NMS "
          f"alone {c['nms_flops']:.0f} flops")
    return c


if __name__ == "__main__":
    main()
