"""The port's cost count (``radardistill_tpu_torch/utils/profiler.py::
cost_analysis``, ``tools/torch_test.py --cal_params``) against XLA's cost
analysis (the JAX tool's ``--cal_params``), on the CPU.

(i) Each per-op rule (44 ops): the same single op through the port's counter and
    through XLA's ``cost_analysis()`` of the lax op it stands for; the flops
    are equal as integers (both count the same arithmetic, no tolerance).
(ii) Parameters: each shipped yaml's model holds as many parameters as the
    JAX model holds under ``params`` (``jax.eval_shape`` of ``init``, nothing
    compiled); exact.
(iii) The val eval step at grid 256, bs1, float32 (the setup of
    ``tests/test_torch_slice.py``): the port's flops within 5% of XLA's count
    of the JAX eval step on the same batch, recomputed here. Both programs
    compute the same function but not always with the same work, and the
    count follows the work: the JAX decode compacts each clipped polygon
    with a masked sum over a (16, 8) one-hot, the port with a scatter; XLA
    counts about 4.4 G for the masked sums at this grid, which the port
    does not do; and the JAX head's last convs run dense over its 384
    channels with block-diagonal kernels where the port runs them grouped,
    0.44 G. So the JAX step is compiled with its ``_clip_halfplane_batched``
    written as the port writes it (``tools/xla_cost_reference.py
    --scatter_compaction``; the JAX package is unchanged), and the 5% holds
    the rest: the head's 0.44 G, elementwise formulations that differ op by
    op (the decode's selects and index arithmetic) and XLA's own rewrites,
    3.2% in all here. Likewise the NMS: the port's decode runs it as two
    kernels (``csrc/nms_bev.cu``), counted by their formula (the upper
    triangle's clipping, 0.25 G here), where the JAX decode computes the
    dense IoU matrix, 4.5 G in XLA's count; so the JAX step's count is taken
    with its NMS counted as the port's (XLA's count of the JAX NMS alone at
    the decode's shapes out, ``tools/xla_cost_reference.py::
    decode_nms_cost``, the kernels' formula in), and the port's own count,
    as ``--cal_params`` reports it, is held to that within 5% of XLA's
    count: 1.9% here.
    The split (conv, matmul, elementwise, kernels) is printed.
(iv) Each kernel's formula (its module's ``*_work``) at the shapes of its
    PERF.md section 6 row, summed and divided as the table divides (bytes
    over 3.35 TB/s, operations over the peak of their type), equals the
    table's bound to its printed four decimals. K8's bound depends on its
    tables' data; its formula is held to a gather whose distinct rows are
    known.
(v) The CLI: ``tools/torch_test.py --cal_params --device cpu`` on
    ``synthetic/smoke.yaml`` (two samples, its range cut to a 128² grid) logs
    the JAX tool's line.
"""

import copy
import re
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from radardistill_tpu_torch.utils.profiler import cost_analysis

torch.set_num_threads(1)  # beside the other test workers

REPO = Path(__file__).resolve().parent.parent
SHIPPED = ("radar_distill/radar_distill_train.yaml", "radar_distill/radar_distill_val.yaml",
           "nuscenes_models/pillarnet.yaml", "nuscenes_models/pillarnet_radar.yaml")


def _xla_flops(fn, *args):
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    return (ca[0] if isinstance(ca, list) else ca).get("flops", 0.0)  # absent: none


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _conv(x_shape, w_shape, stride=1, padding="SAME", lhs=1, groups=1):
    """A lax convolution (NHWC, HWIO) and the torch call it stands for."""
    rng = np.random.RandomState(0)
    x, w = rng.randn(*x_shape).astype(np.float32), rng.randn(*w_shape).astype(np.float32)
    k = w_shape[0]
    if lhs == 1:
        pad = padding if isinstance(padding, str) else [(p, p) for p in padding]
        jfn = lambda a, b: lax.conv_general_dilated(  # noqa: E731
            a, b, (stride, stride), pad, dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups)
        tpad = (k // 2) if padding == "SAME" else (0 if padding == "VALID" else padding[0])
        wt = torch.from_numpy(w).permute(3, 2, 0, 1)
        tfn = lambda: F.conv2d(_nchw(x), wt, None, stride, tpad, groups=groups)  # noqa: E731
    else:  # torch ConvTranspose2d(k, s = lhs, p = 1): lax padding k - 1 - p
        jfn = lambda a, b: lax.conv_general_dilated(  # noqa: E731
            a, b, (1, 1), [(k - 2, k - 2)] * 2, lhs_dilation=(lhs, lhs),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        wt = torch.from_numpy(w).permute(2, 3, 0, 1)
        tfn = lambda: F.conv_transpose2d(_nchw(x), wt, None, lhs, 1)  # noqa: E731
    return tfn, jfn, (x, w)


def _elementwise(tfn, jfn, *shapes, ints=None):
    rng = np.random.RandomState(1)
    arrs = [rng.randn(*s).astype(np.float32) for s in shapes]
    if ints is not None:
        arrs.append(ints)
    tens = [torch.from_numpy(a) for a in arrs]
    return (lambda: tfn(*tens)), jfn, tuple(arrs)


def _bn():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    mean, var = rng.randn(16).astype(np.float32), rng.rand(16).astype(np.float32) + 0.5
    scale, bias = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    import flax.linen as nn

    bn = nn.BatchNorm(use_running_average=True, axis=-1, epsilon=1e-3)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    t = [torch.from_numpy(a) for a in (mean, var, scale, bias)]
    tfn = lambda: F.batch_norm(_nchw(x), *t, training=False, eps=1e-3)  # noqa: E731
    return tfn, lambda v, a: bn.apply(v, a), (v, x)


IDX = (np.arange(100) * 7 % 64).astype(np.int64)
CASES = {
    "conv3x3_same": lambda: _conv((1, 16, 16, 32), (3, 3, 32, 32)),
    "conv2x2_stride2": lambda: _conv((1, 16, 16, 32), (2, 2, 32, 64), 2, "VALID"),
    "conv4x4_transposed_lhs_dilation2": lambda: _conv((1, 8, 8, 32), (4, 4, 32, 32), lhs=2),
    "conv2x2_transposed_lhs_dilation2": lambda: _conv((1, 8, 8, 32), (2, 2, 32, 32), lhs=2),
    "conv3x3_stride2": lambda: _conv((1, 16, 16, 32), (3, 3, 32, 27), 2, (1, 1)),
    "depthwise7x7": lambda: _conv((1, 16, 16, 32), (7, 7, 1, 32), groups=32),
    "conv1x1": lambda: _conv((1, 16, 16, 64), (1, 1, 64, 32)),
    "matmul": lambda: _elementwise(torch.matmul, jnp.matmul, (64, 48), (48, 40)),
    "batched_matmul": lambda: _elementwise(torch.matmul, jnp.matmul, (4, 32, 48), (4, 48, 40)),
    "linear_with_bias": lambda: _elementwise(F.linear, lambda a, w, b: a @ w.T + b,
                                             (64, 48), (40, 48), (40,)),
    "add": lambda: _elementwise(torch.add, jnp.add, (4, 8, 8, 16), (4, 8, 8, 16)),
    "mul": lambda: _elementwise(torch.mul, jnp.multiply, (4, 8, 8, 16), (4, 8, 8, 16)),
    "compare": lambda: _elementwise(torch.lt, jnp.less, (4, 8, 8, 16), (4, 8, 8, 16)),
    "where_of_compare": lambda: _elementwise(lambda a, b: torch.where(a < b, a, b),
                                             lambda a, b: jnp.where(a < b, a, b),
                                             (4, 8, 8, 16), (4, 8, 8, 16)),
    "clamp": lambda: _elementwise(lambda a: torch.clamp(a, -1.0, 1.0),
                                  lambda a: jnp.clip(a, -1.0, 1.0), (4, 8, 8, 16)),
    "rsqrt": lambda: _elementwise(torch.rsqrt, lax.rsqrt, (4, 8, 8, 16)),
    "exp": lambda: _elementwise(torch.exp, jnp.exp, (4, 8, 8, 16)),
    "sigmoid": lambda: _elementwise(torch.sigmoid, jax.nn.sigmoid, (4, 8, 8, 16)),
    "sum": lambda: _elementwise(lambda a: a.sum(-1), lambda a: a.sum(-1), (4, 8, 8, 16)),
    "max": lambda: _elementwise(lambda a: a.amax(1), lambda a: a.max(1), (4, 8, 8, 16)),
    "argmax": lambda: _elementwise(lambda a: a.argmax(-1), lambda a: a.argmax(-1), (4, 8, 16)),
    "cumsum_16": lambda: _elementwise(lambda a: a.cumsum(-1), lambda a: jnp.cumsum(a, -1),
                                      (4, 8, 16)),
    "cumsum_300": lambda: _elementwise(lambda a: a.cumsum(-1), lambda a: jnp.cumsum(a, -1),
                                       (3, 300)),
    "sort": lambda: _elementwise(lambda a: torch.sort(a, -1).values,
                                 lambda a: jnp.sort(a, -1), (6, 50)),
    "gather_rows": lambda: _elementwise(lambda a, i: a[i], lambda a, i: a[i], (64, 16),
                                        ints=IDX),
    "index_add": lambda: _elementwise(lambda a, v, i: a.index_add(0, i, v),
                                      lambda a, v, i: a.at[i].add(v), (64, 16), (100, 16),
                                      ints=IDX),
    "batch_norm_eval": _bn,
    "addcmul": lambda: _elementwise(torch.addcmul, lambda a, b, c: a + b * c, *[(4, 8, 16)] * 3),
    "lerp": lambda: _elementwise(torch.lerp, lambda a, b, w: a + w * (b - a), *[(4, 8, 16)] * 3),
    "leaky_relu": lambda: _elementwise(F.leaky_relu, jax.nn.leaky_relu, (4, 8, 16)),
    "nan_to_num": lambda: _elementwise(torch.nan_to_num, jnp.nan_to_num, (4, 8, 16)),
    "isinf": lambda: _elementwise(torch.isinf, jnp.isinf, (4, 8, 16)),
    "pow_3": lambda: _elementwise(lambda a: a ** 3, lambda a: a ** 3, (4, 8, 16)),
    "remainder": lambda: _elementwise(torch.remainder, jnp.remainder, (4, 8, 16), (4, 8, 16)),
    "floor_divide": lambda: _elementwise(torch.floor_divide, jnp.floor_divide, (4, 8, 16),
                                         (4, 8, 16)),
    "softmax": lambda: _elementwise(lambda a: a.softmax(-1), lambda a: jax.nn.softmax(a, -1),
                                    (4, 8, 16)),
    "log_softmax": lambda: _elementwise(lambda a: a.log_softmax(-1),
                                        lambda a: jax.nn.log_softmax(a, -1), (4, 8, 16)),
    "logsumexp": lambda: _elementwise(lambda a: a.logsumexp(-1),
                                      lambda a: jax.nn.logsumexp(a, -1), (4, 8, 16)),
    "vector_norm": lambda: _elementwise(lambda a: torch.linalg.vector_norm(a, dim=-1),
                                        lambda a: jnp.linalg.norm(a, axis=-1), (4, 8, 16)),
    "var": lambda: _elementwise(lambda a: a.var(-1, correction=0), lambda a: a.var(-1),
                                (4, 8, 16)),
    "nansum": lambda: _elementwise(lambda a: a.nansum(-1), lambda a: jnp.nansum(a, -1),
                                   (4, 8, 16)),
    "max_of_all": lambda: _elementwise(lambda a: a.max(), jnp.max, (4, 8, 16)),
    "max_with_indices": lambda: _elementwise(lambda a: a.max(-1),
                                             lambda a: (a.max(-1), a.argmax(-1)), (4, 8, 16)),
    "cummax": lambda: _elementwise(lambda a: a.cummax(-1).values,
                                   lambda a: lax.cummax(a, axis=1), (4, 40)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_flops_equal_xla(case):
    tfn, jfn, jargs = CASES[case]()
    got = cost_analysis(tfn)["flops"]
    want = _xla_flops(jfn, *jargs)
    assert got == want, (case, got, want)


@pytest.mark.parametrize("yaml", SHIPPED)
def test_params_equal_jax(yaml):
    from radardistill_tpu.config import ConfigDict as JConfigDict
    from radardistill_tpu.data.collate import collate_batch
    from radardistill_tpu.data.host_precompute import HostPrecompute
    from radardistill_tpu.data.synthetic import make_scene
    from radardistill_tpu.models import build_network as jax_build_network
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.utils.production import production_cfg

    full, info = production_cfg(str(Path("..") / yaml), grid=64)  # relative to radar_distill/
    model = build_network(full.MODEL, info, device="cpu")
    jcfg = JConfigDict(copy.deepcopy(full.MODEL))
    scene = make_scene(0, num_lidar=500, num_radar=100, num_boxes=4,
                       pc_range=info["point_cloud_range"])
    batch = collate_batch([scene], {"MAX_LIDAR_POINTS": 512, "MAX_RADAR_POINTS": 128,
                                    "NUM_MAX_OBJS": 8})
    batch.pop("_host", None)
    geo = (info["grid_size"], info["voxel_size"], info["point_cloud_range"])
    jbatch = jax.tree.map(jnp.asarray, HostPrecompute(jcfg, *geo)(batch))
    jmodel = jax_build_network(jcfg, info)
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, True), jax.random.PRNGKey(0), jbatch)
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want
    if yaml.endswith("radar_distill_val.yaml"):
        assert want == 24_911_999


@pytest.fixture(scope="module")
def val_counts():
    """(the port's count, XLA's flops, XLA's flops of the JAX NMS alone) of
    the val eval step at grid 256."""
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.train.train_step import make_eval_step
    from tools.xla_cost_reference import decode_nms_cost, val_step_cost

    # the port's step is counted on a second thread while this one traces
    # and compiles the JAX step: much of either is work outside the GIL
    counted = []

    def count_port():
        try:
            cfg, info, batch = make_batch(grid=256)
            model = init_random_(build_network(cfg, info, device="cpu"),
                                 torch.Generator().manual_seed(0))
            counted.append(cost_analysis(make_eval_step(model), batch_to_torch(batch, "cpu")))
        except BaseException as e:  # re-raised on the test's thread
            counted.append(e)

    thread = threading.Thread(target=count_port)
    thread.start()
    xla = val_step_cost(grid=256, scatter_compaction=True)
    xla_nms = decode_nms_cost(scatter_compaction=True)
    thread.join()
    if isinstance(counted[0], BaseException):
        raise counted[0]
    return counted[0], xla["flops"], xla_nms


def test_val_step_flops_within_5pct_of_xla(val_counts):
    """The port's count (``--cal_params``'s) against XLA's count of the JAX
    step with its NMS counted as the port's: XLA's count of the JAX NMS alone
    taken out, the NMS kernels' formula put in (module docstring, iii)."""
    from radardistill_tpu_torch.ops.nms import nms_bev_work

    ca, xla, xla_nms = val_counts
    nms_flops = ca["kernel_flops"]["nms_bev"]
    want = xla - xla_nms + nms_flops
    split = ", ".join(f"{k} {v / 1e9:.3f} G" for k, v in ca["split"].items())
    print(f"val eval step, grid 256: port {ca['flops'] / 1e9:.3f} G ({split}), XLA "
          f"{xla / 1e9:.3f} G, of which the JAX NMS {xla_nms / 1e9:.3f} G, where the port's "
          f"kernels count {nms_flops / 1e9:.3f} G: {want / 1e9:.3f} G "
          f"({100 * (ca['flops'] / want - 1):+.2f}%); bytes {ca['bytes_accessed'] / 1e9:.3f} G")
    assert abs(ca["flops"] - want) <= 0.05 * xla
    # the kernels of the path reported through their formulas, the NMS as
    # one call over the 6 heads' 500 candidates of the sample
    assert ca["kernels"] == {"expand_rows": 1, "dcn_sample": 3, "nms_bev": 1}
    six = torch.empty((6, 500), device="meta")
    assert nms_flops == nms_bev_work(six, six, six, 0.2, 1000, 83)[0]
    assert all(ca["split"][k] > 0 for k in ("conv", "matmul", "elementwise", "kernels"))


def test_val_step_bytes_cover_every_op(val_counts):
    """The eager port moves more bytes than XLA's fused program; at least the
    parameters are read once, and the kernels' formulas are in the total."""
    ca, _, _ = val_counts
    assert ca["bytes_accessed"] > 24_911_999 * 4 + sum(ca["kernel_bytes"].values())


def _meta(*shape, dtype=torch.int8):
    return torch.empty(shape, dtype=dtype, device="meta")


def _rows_k5():
    from radardistill_tpu_torch.ops.expand import expand_rows_work

    bf = torch.bfloat16
    # the conv4 handoff (8192 + 1 rows a sample onto 180²) and the teacher's
    # int8 entry (163 840 + 1 rows a sample onto 1440²), bs2
    return [expand_rows_work(_meta(2 * 8193, 256, dtype=bf), _meta(2 * 180 ** 2, dtype=torch.int32)),
            expand_rows_work(_meta(2 * 163841, 32), _meta(2 * 1440 ** 2, dtype=torch.int32))]


def _cma_sites():
    """The CMA's three sites at 1440², bs2, bfloat16: (x, offset, mask, ds)."""
    f32, bf = torch.float32, torch.bfloat16
    return [(_meta(2, h, h, 256, dtype=bf), _meta(2, ho, ho, 18, dtype=f32),
             _meta(2, ho, ho, 9, dtype=f32), _meta(2, ho, ho, 9 * 256, dtype=bf), h)
            for h, ho in ((180, 90), (90, 45), (180, 90))]


def _rows_k2():
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample_work

    return [dcn_sample_work(x, o, m, 2, 1, 3, 5.0) for x, o, m, _, _ in _cma_sites()]


def _rows_k3():
    from radardistill_tpu_torch.ops.dcn_grad import dcn_offset_grad_work

    return [dcn_offset_grad_work(x, o, ds, m, 2, 1, 3, 5.0) for x, o, m, ds, _ in _cma_sites()]


def _rows_k4():
    from radardistill_tpu_torch.ops.dcn_grad import dcn_input_grad_work

    return [dcn_input_grad_work(ds, o, m, h, h, 2, 1, 3, 5.0) for _, o, m, ds, h in _cma_sites()]


def _rows_k1():
    from radardistill_tpu_torch.ops.conv_block import conv_block_work

    ab = _meta(8, 128, dtype=torch.float32)
    return [conv_block_work(_meta(2, 720, 720, 128), _meta(3, 3, 128, 128), ab,
                            _meta(2, 720, 720, 4), res)
            for res in (None, None, _meta(2, 720, 720, 128), _meta(2, 720, 720, 128))]


FP_LINKS = ((720, 64, 64, 3, 2, 2), (360, 256, 128, 2, 1, 0), (360, 128, 128, 3, 2, 2),
            (180, 512, 256, 2, 1, 0), (180, 256, 256, 3, 2, 2), (90, 1024, 256, 2, 1, 0),
            (90, 256, 256, 3, 2, 2))  # chip_smoke.py's: the 19 links of FP_STAGES: 5


def _rows_k6():
    from radardistill_tpu_torch.ops.conv_block import conv_block_fp_work

    bf, rows = torch.bfloat16, []
    for hw, c, co, kh, n_plain, n_res in FP_LINKS:
        for res, n in ((None, n_plain), (_meta(2, hw, hw, co, dtype=bf), n_res)):
            rows += [conv_block_fp_work(_meta(2, hw, hw, c, dtype=bf), _meta(kh, kh, c, co, dtype=bf),
                                        _meta(2, co, dtype=torch.float32), _meta(2, hw, hw, 1),
                                        res)] * n
    return rows


def _rows_k7():
    from radardistill_tpu_torch.ops.int8_conv import chain_conv_work

    return [chain_conv_work(_meta(2, 91, 90, 1024), _meta(2, 2, 1024, 256),
                            _meta(8, 256, dtype=torch.float32), _meta(2, 90, 90, 256))]


def _rows_k9():
    from radardistill_tpu_torch.ops.wide_conv import conv_or_dx_work

    x, k = _meta(2, 180, 180, 256, dtype=torch.bfloat16), _meta(3, 3, 256, 256,
                                                                dtype=torch.float32)
    return [conv_or_dx_work(x, k), conv_or_dx_work(x, k, backward=True)]


def _rows_nms():
    from radardistill_tpu_torch.ops.nms import nms_bev_work

    # the bs4 decode's call: 24 (sample, head) problems of 500 candidates;
    # the operations are the worst case (nms.PAIR_FLOPS), an upper bound on
    # the work, so the bound is an upper bound on the kernels' floor
    x = _meta(24, 500, dtype=torch.float32)
    return [nms_bev_work(x, x, x, 0.2, 1000, 83)]


def _rows_p1():
    from radardistill_tpu_torch.ops.probes import conv_probe_work

    bf = torch.bfloat16
    return [conv_probe_work(_meta(2, 722, 720, 128, dtype=bf), _meta(3, 3, 128, 128, dtype=bf),
                            "conv")]


def _rows_p2():
    from radardistill_tpu_torch.ops.probes import mma_rate_work

    bf = torch.bfloat16
    return [mma_rate_work(_meta(2048, 512, dtype=bf), _meta(512, 512, dtype=bf), 8)]


PEAK_BYTES, PEAK = 3.35e12, {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
# id: (the rows' formulas, the peak their operations run at, PERF.md's bound)
BOUNDS = {"K5": (_rows_k5, "f32", "0.0602 (bytes)"), "K2": (_rows_k2, "f32", "0.0736 (bytes)"),
          "K1": (_rows_k1, "int8", "0.6201 (operations)"),
          "K3": (_rows_k3, "f32", "0.0748 (bytes)"), "K4": (_rows_k4, "f32", "0.0736 (bytes)"),
          "K6": (_rows_k6, "bf16", "1.1736 (operations)"),
          "K7": (_rows_k7, "int8", "0.0170 (operations)"),
          "K9": (_rows_k9, "bf16", "0.1546 (operations)"),
          "NMS": (_rows_nms, "f32", "0.0148 (operations)"),
          "P1": (_rows_p1, "bf16", "0.3092 (operations)"),
          "P2": (_rows_p2, "bf16", "0.0087 (operations)")}


@pytest.mark.parametrize("kid", sorted(BOUNDS))
def test_kernel_formula_gives_perf_bound(kid):
    rows, peak, printed = BOUNDS[kid]
    ops, nbytes = (sum(v) for v in zip(*rows()))
    ops_ms, bytes_ms = ops / PEAK[peak] * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = f"{max(ops_ms, bytes_ms):.4f} ({'bytes' if bytes_ms >= ops_ms else 'operations'})"
    assert bound == printed, (kid, ops_ms, bytes_ms)


def test_k8_formula_counts_distinct_rows():
    """K8 reads each distinct in-window row once: a gather of 1024 entries
    that repeat 40 rows (runs of 8, no entry outside its window) moves idx,
    40 rows and 1024 rows out; one count of the wrapper reports that."""
    from radardistill_tpu_torch.ops import gather_bench
    from radardistill_tpu_torch.ops.expand import gather_rows_windowed

    table = torch.randn(600, 8)
    idx = (torch.arange(1024) // 8 % 40).to(torch.int32)
    want = 1024 * 4 + 40 * 32 + 1024 * 32
    ca = cost_analysis(gather_rows_windowed, table, idx, 1)
    assert ca["kernels"] == {"gather_rows_windowed": 1} and ca["flops"] == 0
    assert ca["bytes_accessed"] == want
    assert gather_bench.bound_bytes({"table": table, "idx": idx, "n_win": 1}) == want


def test_kernel_counted_once_whichever_route():
    """Inside a kernel's dispatcher nothing else is counted: a count of the
    K5 dispatcher equals its formula, though its plain version runs aten
    ops, and a kernel dispatcher called by another is not counted again
    (K9's float32 route calls K6's)."""
    from radardistill_tpu_torch.ops.expand import expand_rows, expand_rows_work
    from radardistill_tpu_torch.ops.wide_conv import conv3x3_wide, conv_or_dx_work

    table, inv = torch.randn(65, 16), torch.randint(-1, 70, (200,), dtype=torch.int32)
    ca = cost_analysis(expand_rows, table, inv)
    assert (ca["flops"], ca["bytes_accessed"]) == expand_rows_work(table, inv)
    x, k = torch.randn(1, 6, 6, 8), torch.randn(3, 3, 8, 8)
    ca = cost_analysis(conv3x3_wide, x, k)
    assert ca["kernels"] == {"conv3x3_wide": 1}
    assert ca["kernel_flops"]["conv3x3_wide"] == conv_or_dx_work(x, k)[0]


def test_cal_params_cli_logs_the_jax_line(tmp_path, monkeypatch):
    from tools import torch_test, torch_train

    text = (REPO / "tools" / "cfgs" / "synthetic" / "smoke.yaml").read_text()
    text = text.replace("    DATA_PATH: '.'\n", "    DATA_PATH: '.'\n    NUM_SAMPLES: 2\n")
    cfg = tmp_path / "cfg" / "smoke.yaml"
    cfg.parent.mkdir()
    cfg.write_text(text)
    monkeypatch.chdir(tmp_path)
    # a 128² grid and 50 candidates a head: what is tested is the line
    few = ["--set", "MODEL.RADAR_DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE", "50",
           "DATA_CONFIG.POINT_CLOUD_RANGE", "[-4.8,-4.8,-5.0,4.8,4.8,3.0]"]
    args = ["--cfg_file", str(cfg), "--device", "cpu", "--batch_size", "2"]
    state = torch_train.main(args + ["--epochs", "1", "--workers", "0",
                                     "--num_epochs_to_eval", "0"] + few)
    result = torch_test.main(args + ["--cal_params"] + few)
    assert set(result) == {"mAP"}
    (log,) = (tmp_path / "output" / "smoke" / "default" / "eval").glob("log_eval_*.txt")
    line = re.search(r"params: (\d+\.\d\d)M  flops/batch: (\d+\.\d) G  bytes: (\d+\.\d\d) G",
                     log.read_text())
    assert line, log.read_text()[-2000:]
    n = sum(p.numel() for p in state.model.parameters())
    assert line[1] == f"{n / 1e6:.2f}" and float(line[2]) > 0 and float(line[3]) > 0
