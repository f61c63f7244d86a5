"""radardistill_tpu_torch — PyTorch + CUDA port of ``radardistill_tpu``.

The port runs, on an NVIDIA H100, the radar-only RadarDistill detector
(``tools/cfgs/radar_distill/radar_distill_val.yaml``) and the distillation
forward of ``radar_distill_train.yaml`` (the frozen LiDAR teacher beside the
radar student, eval mode). It mirrors the JAX package's layout and names
(``models/``, ``ops/``, ``data/``, ``utils/``, ``config.py``) so each module's
counterpart is easy to find, keeps NHWC at public interfaces, and runs the JAX
package's Pallas kernels on these paths as hand-written CUDA kernels
(``csrc/``): K5, the table expand (``ops/expand.py``); K2, the DCNv2 tap
sampling (``ops/dcn_sample.py``); K1, the fused int8 conv link
(``ops/conv_block.py``). Each kernel has a plain PyTorch version beside it,
which CPU tensors take.

Nothing here imports JAX or the JAX package: the host-side helpers are the
port's own copies, and only the yaml files under ``tools/cfgs/`` are shared.
Kernels and the host library are compiled at first use, never at import.
Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.2.0"
