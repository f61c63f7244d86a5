"""radardistill_tpu_torch — PyTorch + CUDA port of ``radardistill_tpu``.

The port serves the radar-only RadarDistill detector
(``tools/cfgs/radar_distill/radar_distill_val.yaml``) on an NVIDIA H100. It
mirrors the JAX package's layout and names (``models/``, ``ops/``, ``data/``)
so each module's counterpart is easy to find, keeps NHWC at public
interfaces, and runs the JAX package's Pallas kernels on this path as
hand-written CUDA kernels (``csrc/``): K5, the table expand
(``ops/expand.py``), and K2, the DCNv2 tap sampling (``ops/dcn_sample.py``).
Each kernel has a plain PyTorch version beside it, which CPU tensors take.

Nothing here imports JAX. Kernels are compiled with nvcc at first use, never
at import.
"""

__version__ = "0.1.0"
