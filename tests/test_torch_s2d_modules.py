"""The space-to-depth teacher's modules in the port against the JAX package,
float32, CPU: ``PackedMaskedBatchNorm`` in train mode, the two packed densifies
(forward and backward), ``pack_down_kernel_packed_out``, and the whole
``PillarRes18BackBone8xS2D`` on each input route of the JAX module (the dense
VFE's grid, a packed-order table, a linear-order table, and ``pack_stage2``
on a packed-order table) in train and eval mode, against the JAX module and
against the port's own dense ``PillarRes18BackBone8x`` with the same
``state_dict``; then ``INT8: static`` on the dense-input and ``_S2D2``
routes, and the ``_S2D2`` repair of the detector.

Inputs: two seeded occupancy maps of a 32 x 32 grid (about 15% occupied) and
their features; a table route gets the same features as rows, so every route
computes the same function. The JAX variables come from ``jax.eval_shape`` of
the module's ``init`` (no compile), kernels uniform on +-1 / sqrt(fan in),
every BN statistic and scale and every bias from ``_perturb``, bridged by
``convert.py``. The float backbone runs under one ``jit`` a route (its
backward op by op costs more than the compile); the int8 chain runs op by op,
since under one ``jit`` XLA's CPU backend fuses the int8 link's multiply-add
into another rounding (``tests/test_torch_chain.py``). A gradient is that of a fixed weighted sum
of every output, ``sum_k sum(out_k * r_k)`` with seeded ``r_k``.

Tolerances (float32):
  - outputs rel-L2 <= 1e-4 (summation order; measured ~1e-6), masks equal,
    the densifies' forward bit-equal (a row gather);
  - running statistics after a train forward within 1e-5 (atol);
  - gradients rel-L2 <= 2e-3 per leaf and for the input (against
    ``jax.grad`` on the dense-input and ``_S2D2`` routes, against the
    port's dense backbone on every route). A conv bias that
    feeds a train-mode BatchNorm has a true gradient of zero (the mean
    subtraction cancels it); both packages give it rounding noise, so it is
    held to 1e-6 x the largest gradient element instead (ROADMAP §3);
  - the packed BatchNorm alone: rtol 1e-5 on its output and gradients;
  - ``INT8: static``: each block of the chain on the input the port's block
    saw, codes within 1 on at most 1e-3 of the entries; the whole backbone
    rel-L2 <= 1e-3, the rule of ``tests/test_torch_chain.py`` at depth 1.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.models import backbone_s2d as js2d
from radardistill_tpu.ops import active_site as jasx
from radardistill_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from radardistill_tpu_torch.models import backbone_s2d as s2d
from radardistill_tpu_torch.models.backbone_sparse2d import PillarRes18BackBone8x
from radardistill_tpu_torch.ops import active_site as asx
from tests.test_torch_slice import _perturb, _rel_l2

torch.set_num_threads(1)

GRID, CAP = 32, 200
OUT = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "x_conv5")
MASKS = ("mask1", "mask2", "mask3", "mask4")
# the input routes of the JAX module, by the module switches that pick them
ROUTES = {
    "dense": dict(table_input=False),
    "packed_table": dict(table_input=True, packed_table=True),
    "linear_table": dict(table_input=True, packed_table=False),
    "s2d2": dict(table_input=True, packed_table=True, pack_stage2=True),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _zero_grad(name):
    """A conv bias that feeds a train-mode BatchNorm: true gradient 0."""
    return name.endswith("bias") and ".conv" in name and "bn" not in name and (
        name.startswith(("conv1_", "conv2_0", "conv2_1", "conv3_0", "conv3_1", "conv4_0",
                         "conv4_1", "conv5_0", "conv5_1")))


@pytest.fixture(scope="module")
def grid():
    """bev (2, G, G, 32), mask (2, G, G), and the same sites as a table in
    packed order and in linear order (rows past the active ones zero, ids
    the sentinel G*G)."""
    rng = np.random.RandomState(3)
    mask = rng.rand(2, GRID, GRID) < 0.15
    bev = (rng.rand(2, GRID, GRID, 32).astype(np.float32) * 2.0) * mask[..., None]
    tables = {}
    for order in ("linear", "packed"):
        uids = np.full((2, CAP), GRID * GRID, np.int32)
        table = np.zeros((2, CAP, 32), np.float32)
        for b in range(2):
            ids = np.flatnonzero(mask[b])
            if order == "packed":
                y, x = ids // GRID, ids % GRID
                ids = ids[np.argsort(((y // 2) * (GRID // 2) + x // 2) * 4 + (y % 2) * 2 + x % 2)]
            assert len(ids) <= CAP
            uids[b, :len(ids)] = ids
            table[b, :len(ids)] = bev[b].reshape(-1, 32)[ids]
        tables[order] = (table, uids)
    return bev, mask, tables


def _inputs(grid, route):
    bev, mask, tables = grid
    if not ROUTES[route]["table_input"]:
        return bev, mask
    return tables["packed" if ROUTES[route].get("packed_table", True) else "linear"]


def _jax_module(route, **kw):
    return js2d.PillarRes18BackBone8xS2D(hw=(GRID, GRID), **ROUTES[route], **kw)


def _port_module(route, **kw):
    return s2d.PillarRes18BackBone8xS2D((GRID, GRID), **ROUTES[route], **kw)


@pytest.fixture(scope="module")
def variables(grid):
    """One variable tree for every route (the parameter tree is the dense
    backbone's), drawn without compiling ``init``."""
    bev, mask, _ = grid
    jm = _jax_module("dense")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), bev, mask, False))
    rng = np.random.RandomState(5)
    flat = flax.traverse_util.flatten_dict({k: dict(v) for k, v in shapes.items()})
    for k, v in flat.items():
        bound = 1.0 / np.sqrt(np.prod(v.shape[:-1])) if k[-1] == "kernel" else 0.0
        flat[k] = (rng.uniform(-bound, bound, v.shape) if bound else np.ones(v.shape)).astype(
            np.float32)
    return _perturb(flax.traverse_util.unflatten_dict(flat), seed=6)


def _cotangents(outs):
    rng = np.random.RandomState(9)
    return {k: rng.randn(*outs[k].shape).astype(np.float32) for k in OUT}


# ------------------------------------------------------ PackedMaskedBatchNorm


def test_packed_masked_batchnorm_train_matches_jax():
    """Output, running statistics and the gradients of x, scale and bias in
    train mode against the JAX module and ``jax.grad``; the eval output and
    the int8 chain's packed affine too."""
    rng = np.random.RandomState(1)
    c = 16
    x = rng.randn(2, 6, 7, 4 * c).astype(np.float32) * 2.0 + 0.5
    mask_p = (rng.rand(2, 6, 7, 4) < 0.4).astype(np.float32)
    gy = rng.randn(*x.shape).astype(np.float32)
    scale, bias = rng.uniform(0.75, 1.25, c).astype(np.float32), rng.uniform(-.1, .1, c).astype(
        np.float32)
    stats = {"mean": rng.uniform(-.1, .1, c).astype(np.float32),
             "var": rng.uniform(.75, 1.25, c).astype(np.float32)}
    jm = js2d.PackedMaskedBatchNorm(c)

    def loss(x, scale, bias):
        y, upd = jm.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, x,
                          mask_p, True, mutable=["batch_stats"])
        return jnp.sum(y * gy), (y, upd)

    (_, (jy, jupd)), jg = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        x, scale, bias)
    bn = s2d.PackedMaskedBatchNorm(c)
    load_jax_variables(bn, {"params": {"scale": scale, "bias": bias}, "batch_stats": stats})
    xt = torch.from_numpy(x).requires_grad_()
    y = bn.train()(xt, torch.from_numpy(mask_p))
    y.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    want = state_dict_from_jax(bn, _np({"params": {"scale": scale, "bias": bias},
                                        "batch_stats": jupd["batch_stats"]}))
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(bn.state_dict()[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    for got, w in zip((xt.grad, bn.weight.grad, bn.bias.grad), jg):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())
    # eval: the running statistics tiled over the phases; the packed affine
    jy_eval = jm.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, x,
                       mask_p, False)
    load_jax_variables(bn, {"params": {"scale": scale, "bias": bias}, "batch_stats": stats})
    with torch.no_grad():
        np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).numpy(), np.asarray(jy_eval),
                                   rtol=1e-6, atol=1e-6)
    jaff = jm.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, None,
                    None, False, affine=True)
    for got, w in zip(bn.affine(), jaff):
        np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(w), rtol=1e-6)


# ------------------------------------------------------ the packed densifies


@pytest.mark.parametrize("order", ["linear", "packed"])
@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_packed_densify_matches_jax_forward_and_grad(grid, order, dtype):
    """``densify_packed_batch`` (linear-order table) and
    ``densify_packed_direct_batch`` (packed-order table): the dense rows and
    the mask bit-equal to the JAX functions', and the table's gradient equal
    to ``jax.grad``'s (a gather of the cotangent, so exact too); an int8
    table takes no gradient."""
    table, uids = grid[2][order]
    jfn = jasx.densify_packed_batch if order == "linear" else jasx.densify_packed_direct_batch
    tfn = asx.densify_packed_batch if order == "linear" else asx.densify_packed_direct_batch
    if dtype == np.int8:
        table = np.round(table * 50).astype(np.int8)
    jx, jm = jfn(jnp.asarray(table), jnp.asarray(uids), (GRID, GRID))
    t = torch.from_numpy(table)
    if dtype == np.float32:
        t.requires_grad_()
    tx, tm = tfn(t, torch.from_numpy(uids), (GRID, GRID))
    np.testing.assert_array_equal(tx.detach().numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.asarray(jm).sum() == (uids < GRID * GRID).sum()
    if dtype == np.int8:
        assert not tx.requires_grad
        return
    gy = np.random.RandomState(4).randn(*tx.shape).astype(np.float32)
    jg = jax.grad(lambda f: jnp.sum(jfn(f, jnp.asarray(uids), (GRID, GRID))[0] * gy))(
        jnp.asarray(table))
    tx.backward(torch.from_numpy(gy))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    assert np.abs(np.asarray(jg)).max() > 0


def test_packed_densify_refuses_an_odd_grid(grid):
    table, uids = grid[2]["linear"]
    for fn in (asx.densify_packed_batch, asx.densify_packed_direct_batch):
        with pytest.raises(ValueError, match="even grid"):
            fn(torch.from_numpy(table), torch.from_numpy(uids), (GRID - 1, GRID))


def test_pack_down_kernel_packed_out_matches_jax():
    k = np.random.RandomState(2).randn(3, 3, 5, 7).astype(np.float32)
    want = np.asarray(js2d.pack_down_kernel_packed_out(jnp.asarray(k), 5, 7))
    got = s2d.pack_down_kernel_packed_out(torch.from_numpy(k), 5, 7).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- the whole backbone


# the routes whose gradients are also held against jax.grad: the two stage
# structures. A table route differs from the dense one only by its entry,
# whose gradient is held against jax.grad above, and its whole gradient is
# held against the dense backbone's below (a compile of the JAX backward
# costs ~5 s a route)
GRAD_ROUTES = ("dense", "s2d2")


@pytest.fixture(scope="module")
def jax_runs(grid, variables):
    """Per route, the JAX module's eval outputs, its train outputs and the
    statistics they leave, and for ``GRAD_ROUTES`` the gradients of the
    parameters and of the input: one ``jit`` a route (the float path; op by
    op the backward costs more than the compile)."""
    runs = {}
    for route in ROUTES:
        jm = _jax_module(route, unpack_outputs=True)
        a, b = _inputs(grid, route)
        cot = _cotangents(jax.eval_shape(lambda: jm.apply(variables, a, b, False)))

        def loss(params, a):
            out, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, a,
                                b, True, mutable=["batch_stats"])
            return sum(jnp.sum(out[k] * cot[k]) for k in OUT), (out, upd)

        @jax.jit
        def run(variables, a):
            if route in GRAD_ROUTES:
                return jm.apply(variables, a, b, False), jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True)(variables["params"], a)
            return jm.apply(variables, a, b, False), (loss(variables["params"], a), (None, None))

        ev, ((_, (tr, upd)), (gp, ga)) = _np(run(variables, jnp.asarray(a)))
        runs[route] = dict(eval=ev, train=tr, stats=upd["batch_stats"], grads=gp, grad_in=ga,
                           cot=cot)
    return runs


def _port_run(model, a, b, cot, train):
    """Outputs of ``model``; in train mode also the input's gradient and
    the parameters' of the weighted sum."""
    at = torch.from_numpy(a)
    if train:
        at.requires_grad_()
    with torch.set_grad_enabled(train):
        out = model.train(train)(at, torch.from_numpy(b))
    if train:
        sum((out[k] * torch.from_numpy(cot[k])).sum() for k in OUT).backward()
    return out, at.grad


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_s2d_backbone_matches_jax(grid, variables, jax_runs, route, train):
    """Outputs and masks; in train mode the running statistics it leaves and
    the gradients of every parameter and of the input."""
    run = jax_runs[route]
    a, b = _inputs(grid, route)
    model = load_jax_variables(_port_module(route, unpack_outputs=True), variables)
    out, grad_in = _port_run(model, a, b, run["cot"], train)
    want = run["train" if train else "eval"]
    for k in OUT + MASKS:
        got = out[k].detach().numpy()
        assert got.shape == want[k].shape, k
        if k.startswith("mask"):
            np.testing.assert_array_equal(got, want[k])
        else:
            assert np.abs(want[k]).max() > 0 and _rel_l2(got, want[k]) <= 1e-4, k
    if not train:
        return
    sd = state_dict_from_jax(model, {"params": variables["params"], "batch_stats": run["stats"]})
    stats = [k for k in sd if "running_" in k]
    assert len(stats) == 2 * 24
    for k in stats:
        np.testing.assert_allclose(model.state_dict()[k].numpy(), sd[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    if route not in GRAD_ROUTES:
        return
    assert _rel_l2(grad_in.numpy(), run["grad_in"]) <= 2e-3
    jg = state_dict_from_jax(model, {"params": run["grads"]})
    top = max(float(g.abs().max()) for g in jg.values())
    for n, p in model.named_parameters():
        if _zero_grad(n):
            assert p.grad.abs().max() <= 1e-6 * top and jg[n].abs().max() <= 1e-6 * top, n
        else:
            assert _rel_l2(p.grad.numpy(), jg[n].numpy()) <= 2e-3, n


@pytest.mark.parametrize("route", list(ROUTES))
def test_s2d_backbone_equals_the_dense_backbone(grid, variables, jax_runs, route):
    """The port's S2D backbone on each route against the port's dense
    ``PillarRes18BackBone8x`` with the same ``state_dict`` (the two take one
    checkpoint, ``pack_stage2`` included), both in train mode on the same
    grid: outputs, running statistics and the gradients of the parameters
    and of the input (a table's rows: the grid's gradient at their sites)."""
    bev, mask, _ = grid
    a, b = _inputs(grid, route)
    cot = jax_runs[route]["cot"]
    model = load_jax_variables(_port_module(route, unpack_outputs=True), variables)
    dense = PillarRes18BackBone8x()
    dense.load_state_dict(model.state_dict())
    out, grad_in = _port_run(model, a, b, cot, True)
    dout, dgrad_in = _port_run(dense, bev, mask, cot, True)
    if ROUTES[route]["table_input"]:
        valid = b < GRID * GRID
        rows = dgrad_in.reshape(2, GRID * GRID, 32)[
            torch.arange(2)[:, None], torch.from_numpy(np.minimum(b, GRID * GRID - 1)).long()]
        dgrad_in = rows * torch.from_numpy(valid)[..., None]
    assert _rel_l2(grad_in.numpy(), dgrad_in.numpy()) <= 2e-3
    for k in OUT:
        assert _rel_l2(out[k].detach().numpy(), dout[k].detach().numpy()) <= 1e-4, k
    for k in MASKS:
        assert torch.equal(out[k], dout[k]), k
    dsd, dparams = dense.state_dict(), dict(dense.named_parameters())
    for k, v in model.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), dsd[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    top = max(float(p.grad.abs().max()) for p in dparams.values())
    for n, p in model.named_parameters():
        g, dg = p.grad.numpy(), dparams[n].grad.numpy()
        if _zero_grad(n):
            assert np.abs(g).max() <= 1e-6 * top and np.abs(dg).max() <= 1e-6 * top, n
        else:
            assert _rel_l2(g, dg) <= 2e-3, n


def test_table_routes_without_unpacking_keep_the_shipped_keys(grid, variables):
    """Without ``unpack_outputs`` the outputs are the detector's: x_conv2..5
    (``x_conv2_packed`` under ``pack_stage2``) and mask2..4."""
    for route in ROUTES:
        a, b = _inputs(grid, route)
        model = load_jax_variables(_port_module(route), variables).eval()
        with torch.no_grad():
            out = model(torch.from_numpy(a), torch.from_numpy(b))
        x2 = "x_conv2_packed" if route == "s2d2" else "x_conv2"
        assert set(out) == {x2, "x_conv3", "x_conv4", "x_conv5", "mask2", "mask3", "mask4"}
        if route == "s2d2":
            assert tuple(out[x2].shape) == (2, GRID // 4, GRID // 4, 256)


# --------------------------------------------------- INT8: static, two routes


def _jax_block(name, route):
    """The JAX block the JAX module runs at ``name`` under ``INT8: static``
    on ``route`` (stage 1, and under ``pack_stage2`` stage 2, in the chain)."""
    if name.startswith("conv1") or (route == "s2d2" and name in ("conv2_0", "conv2_1")):
        return js2d.S2DBasicBlock(32 if name.startswith("conv1") else 64, int8_static=True)
    if name == "conv2_down" and route == "s2d2":
        return js2d.S2DDownBlockPacked(32, 64, int8_static=True)
    if name == "conv3_down" and route == "s2d2":
        return js2d.S2DDownBlock(64, 128, int8_static=True)
    return js2d.S2DDownBlock(32, 64, int8_static=True)


BLOCKS = {"dense": ("conv1_0", "conv1_1", "conv2_down"),
          "s2d2": ("conv1_0", "conv1_1", "conv2_down", "conv2_0", "conv2_1", "conv3_down")}


@pytest.fixture(scope="module")
def static_runs(grid, variables):
    """route -> (route, JAX outputs, port outputs, each chain block's input
    and output in the port), computed once a route."""
    cache = {}

    def run(route):
        if route not in cache:
            a, b = _inputs(grid, route)
            jout = _np(_jax_module(route, int8_static=True).apply(variables, a, b, False))
            model = load_jax_variables(_port_module(route, int8_static=True), variables).eval()
            seen = {}
            for name in BLOCKS[route]:
                getattr(model, name).register_forward_hook(
                    lambda mod, args, out, name=name: seen.__setitem__(name, (args, out)))
            with torch.no_grad():
                tout = model(torch.from_numpy(a), torch.from_numpy(b))
            cache[route] = route, jout, tout, seen
        return cache[route]

    return run


@pytest.fixture(params=list(BLOCKS))
def static_run(request, static_runs):
    return static_runs(request.param)


def test_static_backbone_matches_jax(static_run):
    route, jout, tout, seen = static_run
    for k in ("x_conv3", "x_conv4", "x_conv5"):
        err = _rel_l2(tout[k].numpy(), jout[k])
        print(f"{route} {k}: rel-L2 {err:.2e}")
        assert err <= 1e-3 and np.abs(jout[k]).max() > 0, k
    assert isinstance(seen["conv1_1"][1], tuple)
    if route == "s2d2":  # the packed stage 2 runs in the chain
        assert isinstance(seen["conv2_1"][1], tuple) and seen["conv2_1"][1][0].shape[-1] == 256


def test_static_blocks_match_jax_on_the_same_input(static_run, variables):
    """Each block of the chain, the JAX block on the input the port's block
    saw: an int8 carry within 1 code on at most 1e-3 of the entries; the
    terminus (float out) within 1e-4 rel-L2."""
    route, _, _, seen = static_run
    to_j = lambda t: (tuple(to_j(v) for v in t) if isinstance(t, tuple)  # noqa: E731
                      else jnp.asarray(t.numpy()) if torch.is_tensor(t) else t)
    for name in BLOCKS[route]:
        args, out = seen[name]
        sub = {k: v[name] for k, v in variables.items()}
        jb = _jax_block(name, route)
        x, m = to_j(args[0]), to_j(args[1])
        if name == "conv2_down" and route == "s2d2":
            # the JAX block dilates the stride-1 mask itself: give it that
            full = s2d.depth_to_space(seen["conv1_0"][0][1], 1)[..., 0] > 0
            jout = jb.apply(sub, x, jnp.asarray(full.numpy()), False)[0]
        elif name.endswith("down"):
            jout = jb.apply(sub, x, None, False, m)[0]
        else:
            jout = jb.apply(sub, x, m, False)
        if isinstance(out, tuple):
            diff = np.abs(out[0].numpy().astype(np.int32) - np.asarray(jout[0]).astype(np.int32))
            share = float((diff != 0).mean())
            print(f"{route} {name}: share of differing codes {share:.2e}")
            assert diff.max() <= 1 and share <= 1e-3, name
            assert float(out[1]) == pytest.approx(float(jout[1]), rel=1e-6) and out[2] == jout[2]
            assert (np.asarray(jout[0]) > -127).mean() > 0.01, name
        else:  # the terminus: the same exact integer conv, a float32 epilogue
            got, want = out.numpy(), np.asarray(jout)
            assert np.abs(want).max() > 0 and _rel_l2(got, want) <= 1e-4, name


# ------------------------------------------------- the detector's _S2D2 repair


def test_s2d2_keeps_its_int8_switches_unlike_the_jax_detector(grid, variables, jax_runs,
                                                              static_runs):
    """The JAX detector builds ``_S2D2`` with ``kwargs = dict(pack_stage2=True)``,
    which drops ``INT8: static``: its backbone is a float teacher. The port's
    detector keeps the switch, and its ``_S2D2`` static forward equals the JAX
    *module* built with ``pack_stage2=True, int8_static=True``."""
    from radardistill_tpu.models import build_network as jax_build_network
    from radardistill_tpu.utils.testing import make_model_cfg as jax_make_model_cfg
    from radardistill_tpu_torch.config import ConfigDict
    from radardistill_tpu_torch.models import build_network

    cfg, info = jax_make_model_cfg(grid=GRID, radar=False, distill=None)
    cfg.BACKBONE_3D.NAME = "PillarRes18BackBone8x_S2D2"
    cfg.BACKBONE_3D.TABLE_INPUT = True
    cfg.BACKBONE_3D.INT8 = "static"
    jbb = jax_build_network(cfg, info).bind({}).backbone_3d
    assert jbb.pack_stage2 and jbb.table_input and not jbb.int8_static
    port = build_network(ConfigDict(copy.deepcopy(cfg)), info, device="cpu")
    bb = port.backbone_3d
    assert bb.pack_stage2 and bb.table_input and bb.int8_static
    a, b = _inputs(grid, "s2d2")
    want, float_jax = static_runs("s2d2")[1], jax_runs["s2d2"]["eval"]
    load_jax_variables(bb, variables).eval()
    with torch.no_grad():
        got = bb(torch.from_numpy(a), torch.from_numpy(b))
    for k in ("x_conv3", "x_conv4", "x_conv5"):
        assert _rel_l2(got[k].numpy(), want[k]) <= 1e-3, k
    # the int8 teacher is measurably not the float one the JAX detector runs
    assert _rel_l2(got["x_conv5"].numpy(), float_jax["x_conv5"]) > 1e-3


# ------------------------------------------------------ utils/testing, tables


def test_make_model_cfg_equals_jax():
    from radardistill_tpu.utils import testing as jt
    from radardistill_tpu_torch.utils import testing as tt

    assert tt.CLASS_NAMES == jt.CLASS_NAMES
    assert dict(tt.head_cfg(False)) == dict(jt.head_cfg(False))
    for kw in (dict(), dict(grid=96, radar=False, distill=None, num_max_objs=16),
               dict(grid=64, teacher=False, distill=False, k_per_head=32, nms_post=8)):
        cfg, info = tt.make_model_cfg(**kw)
        jcfg, jinfo = jt.make_model_cfg(**kw)
        assert _plain(cfg) == _plain(jcfg) and info == jinfo, kw


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def test_linear_order_table_reaches_the_backbone_from_host_and_device():
    """``PACKED_TABLE: false``: the host's ``hp_lidar`` table and the one the
    VFE builds on the device are the same linear-order table (ids sorted
    ascending), and the detector wires the linear-order densify."""
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.utils.production import TRAIN_YAML

    over = {"PACKED_TABLE": False, "INT8": False}
    kw = dict(grid=64, num_lidar=1500, num_radar=100, num_boxes=5, backbone_3d=over)
    cfg, info, host = make_batch(TRAIN_YAML, **kw)
    raw = make_batch(TRAIN_YAML, host_precompute=False, **kw)[2]
    uids = host["hp_lidar"]["uids"]
    for row in uids:
        valid = row[row < 64 * 64]
        assert len(valid) > 100 and np.all(np.diff(valid) > 0)
    model = init_random_(build_network(cfg, info, device="cpu"), torch.Generator().manual_seed(0))
    assert not model.backbone_3d.packed_table and not model.vfe.packed_order
    seen = []
    model.backbone_3d.register_forward_pre_hook(lambda mod, args: seen.append(args[1].clone()))
    with torch.no_grad():
        out_h = model(batch_to_torch(host, "cpu"))
        out_d = model(batch_to_torch(raw, "cpu"))
    assert torch.equal(seen[0], torch.from_numpy(uids)) and torch.equal(seen[1], seen[0])
    assert _rel_l2(out_d["x_conv4"].numpy(), out_h["x_conv4"].numpy()) <= 1e-5
