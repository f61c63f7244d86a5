"""Convert a reference pcdet ``.pth`` checkpoint into the port's checkpoint:
``python tools/torch_convert_ckpt.py --src X.pth --dst Y.pth [--report_only]``.

Counterpart of ``tools/convert_torch_ckpt.py`` (SURVEY.md §7 hard part 6:
start stage 2 of the recipe from the released ``pillarnet_fullset_lidar.pth``
teacher without retraining it). The source is read as that tool reads it
(``torch.load``, then its ``model_state`` or the file itself as a bare state
dict), mapped by ``radardistill_tpu_torch.pcdet_convert`` and written in the
port's checkpoint format (``train/checkpoint.py``): ``{model_state,
optimizer_state: {}, epoch: <the source's or 0>, it: 0, version:
"converted"}``, to a temporary name and then renamed. It prints the JAX
tool's lines: ``mapped N/M tensors``, up to 20 ``unmapped:`` keys and
``wrote ...``; with ``--report_only`` it writes nothing.

The file loads where a port checkpoint loads: ``tools/torch_train.py
--pretrained_model`` / ``--ckpt`` / ``--init_from_teacher``, ``tools/torch_test.py
--ckpt``, ``tools/torch_test_teacher.py`` and ``tools/torch_ckpt_surgery.py``.
A file transform on the host: it builds no model and needs no card. The
source is unpickled in full (a pcdet file carries more than tensors), so
convert only files from a source you trust.
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True, help="reference pcdet .pth checkpoint")
    parser.add_argument("--dst", required=True, help="output port checkpoint file")
    parser.add_argument("--report_only", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from radardistill_tpu_torch.pcdet_convert import pcdet_convert

    ckpt = torch.load(args.src, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state", ckpt)
    state, unmapped = pcdet_convert(sd)
    print(f"mapped {len(sd) - len(unmapped)}/{len(sd)} tensors")
    for k in unmapped[:20]:
        print("  unmapped:", k)
    if args.report_only:
        return

    payload = {
        "model_state": state,
        "optimizer_state": {},
        "epoch": int(ckpt.get("epoch", 0)) if isinstance(ckpt, dict) else 0,
        "it": 0,
        "version": "converted",
    }
    dst = Path(args.dst)
    tmp = dst.with_name(f".{dst.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, dst)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
