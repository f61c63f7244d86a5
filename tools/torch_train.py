"""Training entry point of the PyTorch port: ``python tools/torch_train.py
--cfg_file tools/cfgs/synthetic/production_cert.yaml``, run from the
repository root.

Counterpart of ``tools/train.py`` (reference tools/train.py:22-259), with the
same arguments; ``--device`` (default ``cuda``, the card) takes the place of
``--platform``. The flow: the loader (``HostPrecompute`` on its prefetch
thread) -> ``build_network`` -> ``create_train_state`` (the reference's
initializers from a ``torch.Generator`` seeded with ``--seed``, the optimizer
over the trainable parameters) -> resume from the newest checkpoint, or
``--ckpt`` / ``--pretrained_model`` / ``--init_from_teacher`` ->
``train_model`` -> the evaluation of the last ``--num_epochs_to_eval``
checkpoints. Under ``torchrun --nproc_per_node=N`` it trains data-parallel:
each rank reads its slice of the data, the model trains under DDP, and
``--sync_bn`` / ``OPTIMIZATION.SYNC_BN`` pick the leg (1, the default: BN
statistics and loss normalizers over the global batch; 0: per-rank ones, the
running statistics averaged). Rank 0 logs and writes the checkpoints.
``--profile_dir DIR`` traces ``PROFILE_STEPS`` steps before the training
(``utils/profiler.py``: a Chrome trace in DIR), their batches fed by the
trainer's prefetcher, whose wait for each is the span ``data_wait``.
"""

import argparse
import datetime
import itertools
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PROFILE_STEPS = 3  # traced steps under --profile_dir, after one warm step (as tools/train.py)


def parse_config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None, help="batch size")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--pretrained_model", type=str, default=None)
    parser.add_argument("--init_from_teacher", type=str, default=None,
                        help="teacher ckpt: duplicate weights into the radar branch (ckpt.py surgery)")
    parser.add_argument("--seed", type=int, default=666)
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    parser.add_argument("--merge_all_iters_to_one_epoch", action="store_true")
    parser.add_argument("--sync_bn", type=int, choices=(0, 1), default=None,
                        help="1: BN statistics and loss normalizers over the global batch "
                             "(default, also OPTIMIZATION.SYNC_BN); 0: per-rank ones")
    parser.add_argument("--num_epochs_to_eval", type=int, default=1,
                        help="post-train: evaluate the checkpoints of the last N epochs "
                             "(reference tools/train.py:241-259; 0 disables)")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--no-bf16", dest="bf16", action="store_false")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cpu for small runs without a card)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of a few steps here")
    parser.add_argument("--log_interval", type=int, default=50,
                        help="iterations between train-loop log lines")
    args = parser.parse_args(argv)

    from radardistill_tpu_torch.config import ConfigDict, cfg_from_list, cfg_from_yaml_file

    cfg = ConfigDict()
    cfg_from_yaml_file(args.cfg_file, cfg)
    cfg.TAG = Path(args.cfg_file).stem
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def main(argv=None):
    """Returns the trained ``TrainState``."""
    args, cfg = parse_config(argv)
    import torch

    from radardistill_tpu_torch.data.loader import build_dataloader
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.parallel.mesh import make_mesh
    from radardistill_tpu_torch.parallel.multihost import process_count, process_index
    from radardistill_tpu_torch.train.checkpoint import CheckpointManager
    from radardistill_tpu_torch.train.train_step import create_train_state, make_train_step
    from radardistill_tpu_torch.train.trainer import train_model
    from radardistill_tpu_torch.utils.common import (
        create_logger, maybe_init_distributed, set_random_seed,
    )

    maybe_init_distributed(args.device)
    rank, world = process_index(), process_count()
    sync_bn = (args.sync_bn if args.sync_bn is not None
               else int(cfg.OPTIMIZATION.get("SYNC_BN", True))) == 1

    output_dir = Path("output") / cfg.TAG / args.extra_tag
    ckpt_dir = output_dir / "ckpt"
    output_dir.mkdir(parents=True, exist_ok=True)
    log_file = output_dir / f"log_train_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt"
    logger = create_logger(log_file, rank=rank)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                + (f", {world} ranks, sync_bn {int(sync_bn)}" if world > 1 else ""))

    if args.fix_random_seed:
        set_random_seed(args.seed)

    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS

    train_set, train_loader = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
        root_path=cfg.DATA_CONFIG.get("DATA_PATH", None), workers=args.workers,
        logger=logger, training=True, seed=args.seed, total_epochs=epochs,
        merge_all_iters_to_one_epoch=args.merge_all_iters_to_one_epoch,
        process_index=rank, process_count=world, model_cfg=cfg.MODEL,
    )

    dataset_info = {
        "grid_size": tuple(int(x) for x in train_set.grid_size[:2]),
        "voxel_size": tuple(float(x) for x in train_set.voxel_size),
        "point_cloud_range": tuple(float(x) for x in train_set.point_cloud_range),
        "class_names": tuple(cfg.CLASS_NAMES),
    }
    model = build_network(
        cfg.MODEL, dataset_info,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device,
        remat=bool(cfg.MODEL.get("REMAT", False)),
    )
    total_steps = len(train_loader) * epochs
    state, lr_sched = create_train_state(model, cfg.OPTIMIZATION, total_steps,
                                         torch.Generator().manual_seed(args.seed))

    ckpt_mgr = CheckpointManager(ckpt_dir, args.max_ckpt_save_num)
    start_epoch = 0
    start_it = 0
    if args.pretrained_model or args.ckpt:
        state = ckpt_mgr.load_params_from_file(
            state, args.ckpt or args.pretrained_model,
            pretrained_overlay=args.pretrained_model if args.ckpt else None,
        )
        logger.info(f"loaded {state.loaded} of {len(model.state_dict())} model entries from "
                    f"{args.ckpt or args.pretrained_model}")
    elif args.init_from_teacher:
        state = ckpt_mgr.load_params_from_file(state, args.init_from_teacher,
                                               teacher_to_radar=True)
        logger.info(f"loaded {state.loaded} of {len(model.state_dict())} model entries from "
                    f"{args.init_from_teacher}")
        logger.info(f"duplicated teacher weights into radar branch "
                    f"({state.duplicated} parameters)")
    else:
        resumed = ckpt_mgr.restore(state)
        if resumed is not None:
            state, start_epoch, resume_it = resumed
            # mid-epoch resume: `it` beyond the epoch boundary means a
            # time-interval latest save — continue within the epoch
            spe = max(len(train_loader), 1)
            start_it = min(max(resume_it - start_epoch * spe, 0), spe - 1) \
                if resume_it > start_epoch * spe else 0
            logger.info(f"resumed from epoch {start_epoch} it {resume_it} "
                        f"(mid-epoch offset {start_it})")

    step_fn = make_train_step(
        model, state.optimizer, cfg.MODEL, tuple(cfg.CLASS_NAMES),
        dataset_info["voxel_size"], dataset_info["point_cloud_range"],
        mesh=make_mesh(device) if world > 1 else None, sync_bn=sync_bn,
    )

    tb = None
    if rank == 0:
        try:
            from tensorboardX import SummaryWriter
            tb = SummaryWriter(str(output_dir / "tensorboard"))
        except ImportError:
            pass

    # optional wandb (reference: rank-0 wandb init, tools/train.py:184-198)
    if os.environ.get("WANDB_PROJECT") and rank == 0:
        try:
            import wandb

            wandb.init(project=os.environ["WANDB_PROJECT"], name=f"{cfg.TAG}/{args.extra_tag}",
                       config={"cfg_file": args.cfg_file})
        except ImportError:
            logger.warning("wandb not installed; skipping")

    if args.profile_dir:
        # a trace of a few steps, one warm step outside it (utils/profiler.py),
        # before the training proper; the batches come through the trainer's
        # prefetcher, so the trace holds the input waits training has
        from radardistill_tpu_torch.train.trainer import _DevicePrefetcher
        from radardistill_tpu_torch.utils.profiler import trace

        batches = iter(_DevicePrefetcher(
            itertools.islice(itertools.cycle(train_loader), PROFILE_STEPS + 1), device))
        step_fn(next(batches))
        with trace(args.profile_dir):
            for batch in batches:
                metrics = step_fn(batch)
            float(metrics["loss"])
        del batches, batch
        logger.info(f"profiler trace of {PROFILE_STEPS} steps written to {args.profile_dir}")

    logger.info("**********************Start training**********************")
    state = train_model(
        step_fn, state, train_loader, lr_sched, cfg, epochs, ckpt_dir,
        start_epoch=start_epoch, logger=logger, tb_writer=tb,
        ckpt_save_interval=args.ckpt_save_interval,
        max_ckpt_save_num=args.max_ckpt_save_num, device=device,
        start_it=start_it, log_interval=args.log_interval,
    )
    logger.info("**********************Training done**********************")

    # post-train sweep: evaluate the last N epochs' checkpoints
    # (reference tools/train.py:241-259 -> repeat_eval_ckpt with
    # start_epoch = epochs - num_epochs_to_eval)
    if args.num_epochs_to_eval > 0:
        from tools.torch_test import eval_ckpt

        logger.info("**********************Start evaluation**********************")
        test_set, test_loader = build_dataloader(
            cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
            root_path=cfg.DATA_CONFIG.get("DATA_PATH", None),
            logger=logger, training=False, process_index=rank, process_count=world,
        )
        eval_output_dir = output_dir / "eval" / "eval_with_train"
        eval_output_dir.mkdir(parents=True, exist_ok=True)
        eval_args = argparse.Namespace(cal_params=False, infer_time=False)
        first_eval_epoch = max(epochs - args.num_epochs_to_eval, 0)
        for e in sorted(ckpt_mgr.list_epochs()):
            if e <= first_eval_epoch:
                continue
            restored = ckpt_mgr.restore(state, epoch=e)
            if restored is None:
                continue
            st, _, _ = restored
            result = eval_ckpt(eval_args, cfg, st, test_set, test_loader,
                               logger, eval_output_dir, f"epoch_{e}")
            logger.info(f"eval_with_train epoch {e}: {result}")
        logger.info("**********************End evaluation**********************")
    return state


if __name__ == "__main__":
    main()
