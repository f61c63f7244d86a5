"""Multi-scene quality gate of the PyTorch port, with error bars: ``python
tools/torch_quality_gate.py --variant int8|fp|dcn_r8 [--scenes 8] [--steps_a
300] [--steps_b 256] [--grid 256] [--int8_stages 1] [--device cuda|cpu]``, run
from the repository root.

Counterpart of ``tools/quality_gate.py`` (the same arguments, ``--device``
for ``--platform``, and the same ``RESULT`` and ``gate:`` lines). Per scene
(seed 1000 + s):

  Phase A: jointly overfit the full distillation graph of
           ``utils/testing.make_model_cfg`` with the float space-to-depth
           teacher (``PillarRes18BackBone8x_S2D`` on the dense VFE's grid)
           unfrozen: a trained teacher whose BN statistics describe the data.
  Phase B: freeze the teacher, start a new optimizer, and distil the radar
           branch twice from the same state, the BASE leg and the VARIANT
           leg; compare the final distillation loss and the student's scene
           mAP (centre-distance AP).

Variants:
  int8    BASE float32 teacher      VARIANT ``INT8: static`` (``--int8_stages``)
  fp      BASE float32 teacher      VARIANT ``FP_STAGES: 5``, the fused float chain
  dcn_r8  BASE ``DCN_R`` 5          VARIANT ``DCN_R`` 8 (the radar branch's clamp)

The models compute in bfloat16, as the reference's tool. The gate passes
("NEUTRAL-OR-BETTER") when the mean loss delta lies within 2 standard errors
of 0 and the mean mAP delta is above -2 standard errors. ``main`` returns
``{"d_loss": [...], "d_ap": [...], "ship": bool}``.
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from tools.torch_overfit_check import OPTIM, scene_ap, scene_batch  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--variant", choices=("int8", "fp", "dcn_r8"), required=True)
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--steps_a", type=int, default=300)
    p.add_argument("--steps_b", type=int, default=256)
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--int8_stages", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from radardistill_tpu_torch.config import ConfigDict
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.train.train_step import create_train_state, make_train_step
    from radardistill_tpu_torch.utils.testing import CLASS_NAMES, make_model_cfg

    cfg, info = make_model_cfg(grid=args.grid, num_max_objs=64, k_per_head=128, nms_post=32)
    cfg.BACKBONE_3D.NAME = "PillarRes18BackBone8x_S2D"
    teacher_freeze = list(cfg.FREEZE_PIPELINE)
    cfg.FREEZE_PIPELINE = []
    optim_cfg = ConfigDict(OPTIM)

    def leg_cfg(which):
        """(model cfg, environment) of the BASE or VARIANT leg."""
        c = ConfigDict(cfg)
        c.FREEZE_PIPELINE = teacher_freeze
        c.BACKBONE_3D = ConfigDict(cfg.BACKBONE_3D)
        env = {}
        if args.variant == "int8" and which == "variant":
            c.BACKBONE_3D.INT8 = "static"
            c.BACKBONE_3D.INT8_STAGES = args.int8_stages
        if args.variant == "fp" and which == "variant":
            c.BACKBONE_3D.FP_STAGES = 5
        if args.variant == "dcn_r8":
            env["DCN_R"] = "8" if which == "variant" else "5"
        return c, env

    def run(model, model_cfg, optimizer, batch, n, tag):
        step = make_train_step(model, optimizer, model_cfg, CLASS_NAMES, info["voxel_size"],
                               info["point_cloud_range"])
        t0, last = time.time(), None
        for i in range(n):
            m = step(batch)
            if i == n - 1:
                last = float(m["loss"])
        print(f"    [{tag}] {n} steps, final loss {last:.3f} ({time.time() - t0:.0f}s)",
              flush=True)
        return last

    d_loss, d_ap = [], []
    for s in range(args.scenes):
        scene, batch = scene_batch(1000 + s, info, args.device)
        print(f"scene {s}:", flush=True)

        # phase A: joint float overfit, the teacher unfrozen (shared by both legs)
        model_a = build_network(cfg, info, compute_dtype=torch.bfloat16, device=args.device)
        state_a, _ = create_train_state(model_a, optim_cfg, args.steps_a)
        run(model_a, cfg, state_a.optimizer, batch, args.steps_a, "A joint")
        trained = {k: v.detach().clone() for k, v in model_a.state_dict().items()}
        del model_a, state_a

        res = {}
        for which in ("base", "variant"):
            c, env = leg_cfg(which)
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                model_b = build_network(c, info, compute_dtype=torch.bfloat16, device=args.device)
                model_b.load_state_dict(trained)
                opt_b, _ = build_optimizer(optim_cfg, model_b, args.steps_b, model_b.frozen)
                loss_b = run(model_b, c, opt_b, batch, args.steps_b, f"B {which}")
                res[which] = (loss_b, scene_ap(model_b, batch, scene))
                del model_b, opt_b
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        (lb, ab), (lv, av) = res["base"], res["variant"]
        d_loss.append(lv - lb)
        d_ap.append(av - ab)
        print(f"  scene {s}: loss {lb:.3f} -> {lv:.3f} (d {lv - lb:+.3f}), "
              f"mAP {ab:.3f} -> {av:.3f} (d {av - ab:+.3f})", flush=True)

    d_loss, d_ap = np.asarray(d_loss), np.asarray(d_ap)
    n = len(d_loss)
    sd_l = d_loss.std(ddof=1) if n > 1 else float("nan")
    sd_a = d_ap.std(ddof=1) if n > 1 else float("nan")
    se_l, se_a = sd_l / np.sqrt(n), sd_a / np.sqrt(n)
    print(f"\nRESULT variant={args.variant} over {n} scenes (variant - base):")
    print(f"  distill-loss delta: {d_loss.mean():+.4f} ± {sd_l:.4f} (SE {se_l:.4f})")
    print(f"  scene-mAP   delta: {d_ap.mean():+.4f} ± {sd_a:.4f} (SE {se_a:.4f})")
    ship = bool((abs(d_loss.mean()) <= 2 * se_l) and (d_ap.mean() >= -2 * se_a))
    verdict = "NEUTRAL-OR-BETTER (shippable)" if ship else "REGRESSION (reject or justify)"
    print(f"  gate: {verdict}")
    return {"d_loss": d_loss.tolist(), "d_ap": d_ap.tolist(), "ship": ship}


if __name__ == "__main__":
    main()
