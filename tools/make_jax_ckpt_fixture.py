"""Write the JAX checkpoint fixture of the port's restore tests.

    JAX_PLATFORMS=cpu python tools/make_jax_ckpt_fixture.py --out tests/fixtures/jax_run

writes ``checkpoint_epoch_1/`` and ``checkpoint_epoch_2/`` under ``--out``, as
``tools/train.py`` leaves them in its ``ckpt`` directory: the JAX package's
own ``CheckpointManager.save`` of the ``TrainState`` of
``tools/cfgs/radar_distill/radar_distill_train.yaml`` at its full widths
(``params``, ``batch_stats``, the ``adam_onecycle`` state under the frozen
teacher's ``optax.masked``, ``step``), with ``epoch`` and ``it``. The tree's
shapes come from ``jax.eval_shape`` of ``model.init`` and of the optimizer's
``init`` (nothing is compiled), its values from
``radardistill_tpu_torch.utils.testing.jax_ckpt_leaf`` (numpy alone, so the
port's tests and ``chip_smoke.py`` can remake every value without JAX). The
pattern compresses about a thousandfold, and the two epochs take about a
megabyte on disk.

A JAX tool: it imports the JAX package (the port's import walk reads only
``tools/torch_*.py``). The tests also call ``state_template`` and ``fill`` for
the ``adam`` and ``sgd`` states they compare.
"""

import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

EPOCHS = (1, 2)


def state_template(optim=None, grid=None, yaml_name="radar_distill_train.yaml",
                   total_steps=1000, variables=None):
    """(TrainState of ``jax.ShapeDtypeStruct``, tx, frozen scopes) of the
    shipped yaml's model, with ``optim`` overriding keys of its
    OPTIMIZATION (e.g. ``{"OPTIMIZER": "sgd", "LR": 0.01, "MOMENTUM": 0.9}``).
    ``grid`` rescales the range (the parameters' shapes do not depend on
    it). ``variables``: the model's ``params`` and ``batch_stats`` shapes of
    an earlier call, whose ``eval_shape`` is then not traced again."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from radardistill_tpu.models import build_network
    from radardistill_tpu.models.detector import FREEZE_NAME_TO_SCOPE
    from radardistill_tpu.train.optim import build_optimizer
    from radardistill_tpu.train.train_step import TrainState
    from radardistill_tpu.utils.production import production_cfg
    from radardistill_tpu_torch.data import collate, synthetic

    full, info = production_cfg(yaml_name, grid=grid)
    if optim:
        full.OPTIMIZATION.update(optim)
    shapes = variables
    if shapes is None:
        scenes = [synthetic.make_scene(s, num_lidar=1000, num_radar=50, num_boxes=4,
                                       pc_range=info["point_cloud_range"]) for s in (0, 1)]
        batch = collate.collate_batch(scenes, {"MAX_RADAR_POINTS": 64, "NUM_MAX_OBJS": 50,
                                               "MAX_LIDAR_POINTS": 1000})
        batch.pop("_host", None)
        model = build_network(full.MODEL, info)
        shapes = jax.eval_shape(lambda k, b: model.init(k, b, True), jax.random.PRNGKey(0),
                                jax.tree.map(jnp.asarray, batch))
    frozen = [s for n in full.MODEL.get("FREEZE_PIPELINE", [])
              for s in FREEZE_NAME_TO_SCOPE.get(n, ())]
    tx, _ = build_optimizer(full.OPTIMIZATION, shapes["params"], total_steps, frozen)
    template = TrainState(step=jax.ShapeDtypeStruct((), np.int32), params=shapes["params"],
                          batch_stats=shapes["batch_stats"],
                          opt_state=jax.eval_shape(tx.init, shapes["params"]))
    return template, tx, frozen


def key_name(k) -> str:
    """One key of a JAX key path as orbax names it."""
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def fill(template, epoch: int):
    """The template's leaves from ``jax_ckpt_leaf`` at their orbax key paths
    (``("state", ...)``)."""
    import jax

    from radardistill_tpu_torch.utils.testing import jax_ckpt_leaf

    return jax.tree_util.tree_map_with_path(
        lambda path, s: jax_ckpt_leaf(("state", *map(key_name, path)), s.shape, s.dtype,
                                      epoch), template)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(ROOT / "tests" / "fixtures" / "jax_run"))
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from radardistill_tpu.train.checkpoint import CheckpointManager
    from radardistill_tpu_torch.utils.testing import jax_ckpt_count

    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    template, _, _ = state_template()
    mgr = CheckpointManager(out, max_ckpt_save_num=len(EPOCHS))
    for epoch in EPOCHS:
        mgr.save(fill(template, epoch), epoch, it=jax_ckpt_count(epoch))
    size = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"wrote {', '.join(p.name for p in sorted(out.iterdir()))} under {out}: "
          f"{size} bytes")


if __name__ == "__main__":
    main()
