"""Teacher->student init checkpoint surgery for the PyTorch port:
``python tools/torch_ckpt_surgery.py --src TEACHER --dst INIT [--cfg_file YAML]``.

Counterpart of ``tools/ckpt_surgery.py`` (reference ckpt.py:1-22: load the
LiDAR teacher checkpoint and duplicate every weight under its radar twin, so
the student branch starts from the LiDAR weights) on the port's checkpoint
file (``train/checkpoint.py``): ``duplicate_teacher_to_radar`` over its
``model_state``, parameters and BN statistics alike, copying where the shapes
match (the radar VFE's first linear keeps its own init: 6 raw radar features
against the lidar's 5).

``--src`` may also be a checkpoint directory of the JAX package (its orbax
checkpoint, read by ``train/jax_ckpt.py`` without JAX). Its arrays are laid
out by the model of ``--cfg_file`` (required then; the device is the CPU),
so the output is the port's file: the duplicated ``model_state``, the optax
state mapped onto that model's optimizer (None where it does not fit it, as
for another ``OPTIMIZER``), ``epoch`` and ``it``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _jax_payload(src, cfg_file):
    """The port's checkpoint payload of the JAX checkpoint directory ``src``
    on the model and optimizer of ``cfg_file``."""
    from radardistill_tpu_torch.config import cfg_from_yaml_file
    from radardistill_tpu_torch.convert import optimizer_state_from_jax
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.train.checkpoint import read_payload
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.utils.production import dataset_info

    cfg = cfg_from_yaml_file(cfg_file)
    model = build_network(cfg.MODEL, dataset_info(cfg), device="cpu")
    payload = read_payload(Path(src), model)
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, 1, model.frozen)
    try:
        optimizer_state = optimizer_state_from_jax(model, optimizer, payload.pop("jax_opt_state"))
    except ValueError as e:
        print(f"optimizer state not carried over: {e}")
        optimizer_state = None
    return {**payload, "optimizer_state": optimizer_state}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True,
                        help="teacher checkpoint: the port's file or a JAX checkpoint directory")
    parser.add_argument("--dst", required=True, help="output init checkpoint file")
    parser.add_argument("--cfg_file", default=None,
                        help="the model's yaml; needed for a JAX checkpoint directory")
    args = parser.parse_args(argv)

    import torch

    from radardistill_tpu_torch.train.checkpoint import duplicate_teacher_to_radar
    from radardistill_tpu_torch.train.jax_ckpt import is_jax_checkpoint

    if is_jax_checkpoint(args.src):
        if not args.cfg_file:
            parser.error("--src is a JAX checkpoint directory: --cfg_file is needed")
        payload = _jax_payload(args.src, args.cfg_file)
    else:
        payload = torch.load(args.src, map_location="cpu", weights_only=True)
    payload["model_state"] = duplicate_teacher_to_radar(payload["model_state"])
    torch.save(payload, args.dst)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
