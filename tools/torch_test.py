"""Evaluation entry point of the PyTorch port: ``python tools/torch_test.py
--cfg_file ... [--ckpt FILE | --eval_all]``, run from the repository root.

Counterpart of ``tools/test.py`` (reference tools/test.py: single-ckpt eval
:413-448 and the --eval_all watcher :451-506 polling the ckpt dir against a
result record; --infer_time latency meter), with the same arguments;
``--device`` (default ``cuda``, the card) takes the place of ``--platform``.
It prints recall, the inference p50 with ``--infer_time`` and
``dataset.evaluation``'s result. ``--cal_params`` (XLA's cost analysis) has
no counterpart here and raises. ``--bev_similarity KEY[,KEY]`` (with
``--sim_pooling``) accumulates class x class similarities of those output
features over the pass (``utils/similarity.py``) and writes their CSVs under
``similarity/``. Under ``torchrun --nproc_per_node=N`` each rank evaluates its
slice of the data and the detections are gathered in rank order before the
evaluation, which rank 0 runs and shares.
"""

import argparse
import datetime
import pickle
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--eval_all", action="store_true")
    parser.add_argument("--eval_tag", type=str, default="default")
    parser.add_argument("--max_waiting_mins", type=float, default=30)
    parser.add_argument("--infer_time", action="store_true")
    parser.add_argument("--cal_params", action="store_true",
                        help="not ported (the JAX tool reads XLA's cost analysis)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cpu for small runs without a card)")
    parser.add_argument("--bev_similarity", type=str, default=None,
                        help="comma-separated output keys whose BEV similarity to analyse")
    parser.add_argument("--sim_pooling", type=str, default="center",
                        choices=["center", "avg", "max"])
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from radardistill_tpu_torch.config import ConfigDict, cfg_from_list, cfg_from_yaml_file

    cfg = ConfigDict()
    cfg_from_yaml_file(args.cfg_file, cfg)
    cfg.TAG = Path(args.cfg_file).stem
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def repeat_eval_ckpt(ckpt_mgr, record_file, max_waiting_mins, restore_fn,
                     eval_fn, logger, sleep=time.sleep, clock=time.time,
                     poll_interval=30.0):
    """--eval_all watcher (reference tools/test.py:451-506): poll the ckpt
    dir, skip epochs already listed in the record file, evaluate new arrivals
    in epoch order (appending each to the record), tolerate unloadable
    checkpoints (restore_fn -> None), and exit once nothing new has arrived
    for max_waiting_mins. `sleep`/`clock` are injectable for tests."""
    record_file = Path(record_file)
    evaluated = set()
    if record_file.exists():
        evaluated = set(int(x) for x in record_file.read_text().split())
    wait_start = clock()
    while True:
        todo = [e for e in ckpt_mgr.list_epochs() if e not in evaluated]
        progressed = False
        for e in sorted(todo):
            restored = restore_fn(e)
            if restored is None:
                continue  # mid-write/corrupt ckpt: retried next poll
            result = eval_fn(e, restored)
            logger.info(f"epoch {e}: {result}")
            evaluated.add(e)
            with open(record_file, "a") as f:
                f.write(f"{e}\n")
            progressed = True
        if progressed:
            # reference resets the wait budget only when a ckpt was actually
            # evaluated (total_time=0, tools/test.py:483)
            wait_start = clock()
        else:
            if clock() - wait_start > max_waiting_mins * 60:
                break
            sleep(poll_interval)
    return evaluated


def eval_ckpt(args, cfg, state, test_set, test_loader, logger, output_dir, epoch_tag):
    """Evaluate ``state``'s model over ``test_loader`` where the model lives:
    recall, the inference p50 (``args.infer_time``), the detections of every
    rank gathered, written to ``eval_{epoch_tag}/result.pkl``, then
    ``test_set.evaluation`` (rank 0 writes and evaluates; every rank returns
    rank 0's dict). Returns the evaluation's dict."""
    if args.cal_params:
        raise NotImplementedError("--cal_params (XLA's cost analysis) is not ported")
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.parallel.multihost import (all_gather_object,
                                                           gather_detections, process_index)
    from radardistill_tpu_torch.train.eval_utils import eval_one_epoch
    from radardistill_tpu_torch.train.train_step import make_eval_step

    device = next(state.model.parameters()).device

    def loader_iter():
        for batch, host in test_loader:
            yield batch_to_torch(batch, device), host

    engines = []
    if getattr(args, "bev_similarity", None):
        from radardistill_tpu_torch.utils.similarity import BEVSimilarityEngine

        pcr = [float(x) for x in test_set.point_cloud_range]
        for key_path in args.bev_similarity.split(","):
            engines.append(BEVSimilarityEngine(key_path.replace(".", "_"), key_path,
                                               cfg.CLASS_NAMES, pcr, pooling=args.sim_pooling))

    det_annos, recall_dict, timing = eval_one_epoch(
        make_eval_step(state.model), loader_iter(), test_set, logger,
        thresh_list=cfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST,
        infer_time=args.infer_time, similarity_engines=engines,
    )
    for eng in engines:
        logger.info(f"similarity analytics [{eng.feature_name}] -> {eng.save(output_dir)}")
    if args.infer_time and timing["p50_ms"]:
        logger.info(f"inference p50: {timing['p50_ms']:.1f} ms/batch")
    det_annos = gather_detections(det_annos)  # every rank's, in rank order
    result_dict = None
    if process_index() == 0:
        # raw detections for offline analysis (reference eval_utils.py result.pkl)
        eval_dir = output_dir / f"eval_{epoch_tag}"
        eval_dir.mkdir(parents=True, exist_ok=True)
        with open(eval_dir / "result.pkl", "wb") as f:
            pickle.dump(det_annos, f)
        result_str, result_dict = test_set.evaluation(
            det_annos, cfg.CLASS_NAMES, output_path=str(eval_dir)
        )
        logger.info(result_str)
    return all_gather_object(result_dict)[0]


def main(argv=None):
    args, cfg = parse_config(argv)
    import torch

    from radardistill_tpu_torch.data.loader import build_dataloader
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.train.checkpoint import CheckpointManager
    from radardistill_tpu_torch.train.train_step import create_train_state
    from radardistill_tpu_torch.parallel.multihost import process_count, process_index
    from radardistill_tpu_torch.utils.common import create_logger, maybe_init_distributed

    maybe_init_distributed(args.device)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    output_dir = Path("output") / cfg.TAG / args.extra_tag / "eval"
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(output_dir / f"log_eval_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt",
                           rank=process_index())

    batch_size = args.batch_size or cfg.OPTIMIZATION.get("BATCH_SIZE_PER_GPU", 1)
    test_set, test_loader = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
        root_path=cfg.DATA_CONFIG.get("DATA_PATH", None),
        logger=logger, training=False,
        process_index=process_index(), process_count=process_count(),
    )
    dataset_info = {
        "grid_size": tuple(int(x) for x in test_set.grid_size[:2]),
        "voxel_size": tuple(float(x) for x in test_set.voxel_size),
        "point_cloud_range": tuple(float(x) for x in test_set.point_cloud_range),
        "class_names": tuple(cfg.CLASS_NAMES),
    }
    model = build_network(cfg.MODEL, dataset_info, compute_dtype=torch.bfloat16,
                          device=device)
    state, _ = create_train_state(model, cfg.OPTIMIZATION, total_steps=1)

    ckpt_mgr = CheckpointManager(args.ckpt_dir or output_dir.parent / "ckpt")

    if args.eval_all:
        def restore_fn(e):
            restored = ckpt_mgr.restore(state, epoch=e)
            return restored[0] if restored is not None else None

        def eval_fn(e, st):
            return eval_ckpt(args, cfg, st, test_set, test_loader,
                             logger, output_dir, f"epoch_{e}")

        repeat_eval_ckpt(
            ckpt_mgr, output_dir / f"eval_list_{args.eval_tag}.txt",
            args.max_waiting_mins, restore_fn, eval_fn, logger,
        )
    else:
        if args.ckpt:
            state = ckpt_mgr.load_params_from_file(state, args.ckpt)
            logger.info(f"loaded {state.loaded} of {len(model.state_dict())} model entries from "
                        f"{args.ckpt}")
            tag = Path(args.ckpt).name
        else:
            restored = ckpt_mgr.restore(state)
            assert restored is not None, "no checkpoint found"
            state, e, _ = restored
            tag = f"epoch_{e}"
        return eval_ckpt(args, cfg, state, test_set, test_loader, logger, output_dir, tag)


if __name__ == "__main__":
    main()
