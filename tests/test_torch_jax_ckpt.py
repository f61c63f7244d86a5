"""The port's restore of the JAX package's checkpoints, CPU.

``train/jax_ckpt.py`` reads an orbax checkpoint directory without JAX, orbax
or tensorstore; every leaf must equal orbax's own restore bit for bit, with
the same structure, on the committed fixture (``tests/fixtures/jax_run``, the
full-width ``radar_distill_train.yaml`` ``TrainState`` that
``tools/make_jax_ckpt_fixture.py`` writes through the JAX package's
``CheckpointManager``) and on a tree written here with float32, bfloat16,
int32 and int64 leaves, 0-d arrays, Python scalars, strings, ``None``,
sequence keys, empty containers, a value above the inline limit, an array of
several chunks, with and without compression; a store with interior B-tree
nodes (tensorstore with tiny nodes) reads key for key. A flipped byte raises
the checksum error. The fixture equals its generator
(``utils/testing.py::jax_ckpt_leaf``). One optimizer step from the mapped
state equals optax's from the JAX state for ``adam_onecycle`` (the frozen
teacher masked), ``adam`` and ``sgd`` at full width: every parameter within
rel-L2 1e-6, the counts equal, every trained parameter moved and every frozen
one kept; the moments within 2e-5, the gradient clip being active (see the
test).
``CheckpointManager`` restores a JAX run directory (model, optimizer,
``step``, ``epoch``, ``it``), rotates and overwrites its directories, and still
skips a corrupt one newest-first; the CLIs take a JAX directory (``--ckpt``,
the train resume, the surgery) at grid 128, whose parameters have the
fixture's shapes. About 35 s in one process with one torch thread.
"""

import json
import logging
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from radardistill_tpu_torch.convert import state_dict_from_jax
from radardistill_tpu_torch.models import build_network
from radardistill_tpu_torch.train import jax_ckpt
from radardistill_tpu_torch.train.checkpoint import CheckpointManager
from radardistill_tpu_torch.train.optim import build_optimizer
from radardistill_tpu_torch.train.train_step import TrainState
from radardistill_tpu_torch.utils.production import production_cfg
from radardistill_tpu_torch.utils.testing import jax_ckpt_count, jax_ckpt_leaf
from tools import make_jax_ckpt_fixture as fixture_tool

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_run"
CFG = str(REPO / "tools" / "cfgs" / "synthetic" / "production_cert_grid128.yaml")
GRID = 128


def _same(got, want, path="tree"):
    """The reader's tree ``got`` is orbax's ``want``: dicts and lists alike,
    arrays of one dtype, shape and bytes (bfloat16 as uint16), scalars,
    strings and ``None`` equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}.{i}")
    elif hasattr(want, "dtype"):
        want = np.asarray(want)
        assert torch.is_tensor(got) and tuple(got.shape) == want.shape, path
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, path
            assert np.array_equal(got.view(torch.uint16).numpy(), want.view(np.uint16)), path
        else:
            assert got.numpy().dtype == want.dtype, path
            assert got.numpy().tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("epoch", [1, 2])
def test_reader_matches_orbax_on_the_fixture(epoch):
    path = FIXTURE / f"checkpoint_epoch_{epoch}"
    _same(jax_ckpt.read_checkpoint(path), ocp.PyTreeCheckpointer().restore(path.absolute()))


@pytest.mark.parametrize("compression", [True, False])
def test_reader_matches_orbax_on_every_dtype_and_structure(tmp_path, compression):
    rng = np.random.RandomState(0)
    tree = {
        "f32": rng.randn(70, 33).astype(np.float32),  # 9 KB: above the 1 KB inline limit
        "bf16": jax.numpy.asarray(rng.randn(5, 3), jax.numpy.bfloat16),
        "i32": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
        "i64": np.asarray(2 ** 40 + 7, np.int64),  # 0-d
        "f32_0d": np.asarray(-1.25, np.float32),
        "chunked": jax.numpy.asarray(rng.randn(50, 37).astype(np.float32)),
        "nested": {"none": None, "empty": {}, "empty_list": [], "empty_tuple": (),
                   "seq": [np.ones(3, np.int32), (7, "s", 2.5)]},
        "version": "radardistill_tpu+0.1.0",
    }
    # several chunks: orbax splits a jax.Array by chunk_byte_size
    args = jax.tree.map(lambda x: ocp.SaveArgs(chunk_byte_size=1024 if x is tree["chunked"]
                                               else None), tree)
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_compression=compression)).save(
        tmp_path / "ck", tree, save_args=args)
    store = jax_ckpt.OcdbtStore(tmp_path / "ck")
    meta = json.loads(store.read("chunked/.zarray"))
    assert meta["chunks"] != meta["shape"]
    assert (meta["compressor"] is not None) == compression
    got = jax_ckpt.read_checkpoint(tmp_path / "ck")
    _same(got, ocp.PyTreeCheckpointer().restore(tmp_path / "ck"))
    assert got["nested"]["seq"][1] == [7, "s", 2.5]


def test_reader_walks_interior_btree_nodes(tmp_path):
    import tensorstore as ts

    spec = ts.KvStore.Spec(f"file://{tmp_path}/kv/|ocdbt:").to_json()
    spec["config"] = {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 8}
    kv = ts.KvStore.open(spec).result()
    with ts.Transaction() as txn:
        for i in range(60):
            kv.with_transaction(txn)[f"key{i:03d}/v"] = b"%d," % i * (1 + i % 7)
    store = jax_ckpt.OcdbtStore(tmp_path / "kv")
    keys = sorted(kv.list().result())
    assert sorted(store.keys()) == keys
    assert all(store.read(k) == kv.read(k).result().value for k in keys)


def test_flipped_byte_raises_the_checksum_error(tmp_path):
    shutil.copytree(FIXTURE / "checkpoint_epoch_1", tmp_path / "ck")
    (node,) = (tmp_path / "ck" / "d").iterdir()  # the top-level B-tree node
    data = bytearray(node.read_bytes())
    data[len(data) // 2] ^= 0x10
    node.write_bytes(bytes(data))
    with pytest.raises(jax_ckpt.CheckpointError, match=f"{node}.*CRC-32C"):
        jax_ckpt.read_checkpoint(tmp_path / "ck")


@pytest.fixture(scope="module")
def jax_template():
    """The JAX TrainState template of radar_distill_train.yaml (eval_shape),
    its adam_onecycle tx, and the frozen scopes."""
    return fixture_tool.state_template(grid=GRID)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, path + (str(i),)).items()}
    return {path: tree}


@pytest.mark.parametrize("epoch", [1, 2])
def test_fixture_equals_the_generator(jax_template, epoch):
    template, _, frozen = jax_template
    got = _flat(jax_ckpt.read_checkpoint(FIXTURE / f"checkpoint_epoch_{epoch}"))
    leaves = {k: v for k, v in got.items() if torch.is_tensor(v)}
    # every array of the JAX state is in the file with its shape and dtype, and
    # equals the generator's value
    specs = {("state", *map(fixture_tool.key_name, p)): s
             for p, s in jax.tree_util.tree_flatten_with_path(template)[0]}
    assert set(leaves) == set(specs) | {("epoch",), ("it",)}
    for path, t in leaves.items():
        spec = specs.get(path)
        dtype = np.dtype(spec.dtype) if spec is not None else t.numpy().dtype
        assert spec is None or tuple(spec.shape) == tuple(t.shape), path
        assert t.numpy().tobytes() == jax_ckpt_leaf(path, t.shape, dtype, epoch).tobytes(), path
    assert int(got[("it",)]) == jax_ckpt_count(epoch) and int(got[("epoch",)]) == epoch
    assert got[("version",)] == "radardistill_tpu+0.1.0"
    # the None leaves: the moments optax.masked leaves out (the frozen teacher
    # and the DCN's down_bias, twice: mu and nu), and optax's empty states
    masked = [p for p, _ in jax.tree_util.tree_flatten_with_path(template.params)[0]
              if p[0].key in frozen or p[-1].key == "down_bias"]
    nones = [p for p, v in got.items() if v is None]
    moments = [p[p.index(m) + 1:] for p in nones for m in ("mu", "nu") if m in p]
    assert len(moments) == 2 * len(masked) and len(nones) - len(moments) == 3
    assert all(p[0] in frozen or p[-1] == "down_bias" for p in moments)
    mu = got[("state", "opt_state", "inner_state", "1", "inner_state", "0", "count")]
    assert int(mu) == jax_ckpt_count(epoch)


@pytest.fixture(scope="module")
def port_model():
    full, info = production_cfg("radar_distill_train.yaml", grid=GRID)
    return full, build_network(full.MODEL, info, device="cpu")


OPTIMIZERS = {
    "adam_onecycle": None,  # the shipped yaml's, read from the fixture
    "adam": {"OPTIMIZER": "adam", "LR": 0.002},
    "sgd": {"OPTIMIZER": "sgd", "LR": 0.01, "MOMENTUM": 0.9},
}


def _jax_state(jax_template, name, tmp_path):
    """(numpy TrainState, tx, the checkpoint directory holding it)."""
    if name == "adam_onecycle":
        template, tx, _ = jax_template
        path = FIXTURE / "checkpoint_epoch_2"
        state = fixture_tool.fill(template, 2)
        return state, tx, path
    shapes = jax_template[0]
    template, tx, _ = fixture_tool.state_template(
        OPTIMIZERS[name], grid=GRID,
        variables={"params": shapes.params, "batch_stats": shapes.batch_stats})
    state = fixture_tool.fill(template, 1)
    # optax reads a constant hyperparameter from the state: keep tx.init's
    real = jax.tree.map(np.asarray, jax.jit(tx.init)(state.params).inner_state[1].hyperparams)
    state = state.replace(opt_state=state.opt_state._replace(inner_state=(
        state.opt_state.inner_state[0],
        state.opt_state.inner_state[1]._replace(hyperparams=real))))
    from radardistill_tpu.train.checkpoint import CheckpointManager as JaxManager

    path = JaxManager(tmp_path / "jax").save(state, 1, it=jax_ckpt_count(1))
    return state, tx, path


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_one_step_from_the_mapped_state_matches_optax(jax_template, port_model, name,
                                                      tmp_path):
    full, model = port_model
    state, tx, path = _jax_state(jax_template, name, tmp_path)
    frozen = set(jax_template[2])
    rng = np.random.RandomState(7)
    grads = jax.tree_util.tree_map_with_path(
        lambda p, v: np.zeros_like(v) if p[0].key in frozen or p[-1].key == "down_bias"
        else (1e-2 * rng.standard_normal(v.shape)).astype(np.float32), state.params)
    # XLA's backend at -O0: the same program, compiled in a third of the time
    update = jax.jit(tx.update).lower(grads, state.opt_state, state.params).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    updates, new_opt = update(grads, state.opt_state, state.params)
    new_params = jax.tree.map(np.asarray, optax.apply_updates(state.params, updates))

    cfg = full.OPTIMIZATION.copy()
    cfg.update(OPTIMIZERS[name] or {})
    optimizer, _ = build_optimizer(cfg, model, 1000, model.frozen)
    port = TrainState(model, optimizer)
    restored = CheckpointManager(path.parent).restore(port, epoch=int(path.name.rsplit("_", 1)[1]))
    assert restored is not None and port.step == int(state.step)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jax_before = state_dict_from_jax(model, {"params": state.params})
    assert all(torch.equal(before[k], v) for k, v in jax_before.items())
    g = state_dict_from_jax(model, {"params": grads})
    for n, p in model.named_parameters():
        p.grad = g[n].clone() if p.requires_grad else None
    optimizer.step()

    after = state_dict_from_jax(model, {"params": new_params})
    params = dict(model.named_parameters())
    worst = max(_rel(params[k].detach(), v) for k, v in after.items())
    assert worst <= 1e-6, worst
    # every trained parameter moved, every frozen one stayed
    assert all(torch.equal(params[k].detach(), before[k]) != params[k].requires_grad
               for k in params)
    counts = [int(v) for p, v in jax.tree_util.tree_flatten_with_path(new_opt)[0]
              if fixture_tool.key_name(p[-1]) == "count"]
    assert set(counts) == {optimizer.count} == {int(state.step) + 1}
    jax_key, port_key = ("trace", "momentum_buffer") if name == "sgd" else ("mu", "exp_avg")
    tree = {}
    for p, v in jax.tree_util.tree_flatten_with_path(new_opt)[0]:
        keys = list(map(fixture_tool.key_name, p))
        if jax_key in keys:
            node = tree
            *scope, leaf = keys[keys.index(jax_key) + 1:]
            for k in scope:
                node = node.setdefault(k, {})
            node[leaf] = np.asarray(v)
    want = state_dict_from_jax(model, {"params": tree})
    name_of = {id(p): n for n, p in model.named_parameters()}
    got = {name_of[id(p)]: s[port_key] for p, s in optimizer.inner.state.items()}
    assert got.keys() == want.keys()
    # the clip is active (norm ~50 > 10) and scales every moment by 10 / norm;
    # the port's float32 norm (torch._foreach_norm on the CPU) is ~5e-6 off the
    # exact one, optax's ~3e-7, so the moments agree to ~6e-6
    exact = np.sqrt(sum((np.asarray(v, np.float64) ** 2).sum() for v in jax.tree.leaves(grads)))
    assert exact > 10 and abs(float(optimizer.grad_norm) / exact - 1) <= 1e-5
    assert max(_rel(got[k], want[k]) for k in want) <= 2e-5


def test_bfloat16_leaves_load_as_the_ports_dtype(port_model):
    _, model = port_model
    tree = jax_ckpt.read_checkpoint(FIXTURE / "checkpoint_epoch_1")["state"]
    f32 = state_dict_from_jax(model, {"params": tree["params"]})
    as_bf16 = jax.tree.map(lambda t: t.to(torch.bfloat16), tree["params"])
    bf16 = state_dict_from_jax(model, {"params": as_bf16})
    assert all(bf16[k].dtype == torch.float32 for k in f32)
    assert all(torch.equal(bf16[k], f32[k].to(torch.bfloat16).float()) for k in f32)


def _run_dir(tmp_path):
    run = tmp_path / "run"
    shutil.copytree(FIXTURE, run)
    return run


def test_restore_reads_a_jax_run_instead_of_skipping_it(port_model, tmp_path, caplog):
    full, model = port_model
    optimizer, _ = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    state = TrainState(model, optimizer)
    mgr = CheckpointManager(_run_dir(tmp_path))
    assert mgr.list_epochs() == [1, 2]
    with caplog.at_level(logging.WARNING):
        restored = mgr.restore(state)
    assert "corrupt" not in caplog.text and "alone" not in caplog.text
    assert restored is not None and restored[1:] == (2, jax_ckpt_count(2))
    assert state.step == jax_ckpt_count(2)
    assert len(optimizer.inner.state) == len(optimizer.params)
    assert mgr.restore(state, epoch=1)[1:] == (1, jax_ckpt_count(1))
    assert state.step == jax_ckpt_count(1)
    tree = jax_ckpt.read_checkpoint(FIXTURE / "checkpoint_epoch_1")["state"]
    want = state_dict_from_jax(model, tree)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())


def test_save_replaces_a_jax_directory_of_the_same_epoch(port_model, tmp_path):
    """As the JAX package's save does (it removes the directory first)."""
    full, model = port_model
    optimizer, _ = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    run = _run_dir(tmp_path)
    path = CheckpointManager(run, max_ckpt_save_num=5).save(TrainState(model, optimizer), 2)
    assert path.is_file() and sorted(p.name for p in run.iterdir()) == [
        "checkpoint_epoch_1", "checkpoint_epoch_2"]


def test_rotate_removes_jax_directories(tmp_path):
    run = _run_dir(tmp_path)
    os.utime(run / "checkpoint_epoch_1", (1, 1))  # the oldest
    CheckpointManager(run, max_ckpt_save_num=1)._rotate()
    assert [p.name for p in run.iterdir()] == ["checkpoint_epoch_2"]


def test_a_corrupt_jax_directory_is_skipped_newest_first(port_model, tmp_path, caplog):
    full, model = port_model
    optimizer, _ = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    run = _run_dir(tmp_path)
    (node,) = (run / "checkpoint_epoch_2" / "d").iterdir()
    node.write_bytes(node.read_bytes()[:-1])  # truncated
    with caplog.at_level(logging.WARNING):
        restored = CheckpointManager(run).restore(TrainState(model, optimizer))
    assert "checkpoint_epoch_2 failed" in caplog.text and "skipping as corrupt" in caplog.text
    assert restored[1] == 1 and optimizer.count == jax_ckpt_count(1)


FEWER = ["--set", "MODEL.RADAR_DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE", "50",
         "DATA_CONFIG.NUM_SAMPLES", "2"]


def test_the_clis_take_a_jax_checkpoint_directory(port_model, tmp_path, monkeypatch):
    from tools import torch_ckpt_surgery, torch_test, torch_train

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "output" / "production_cert_grid128" / "default"
    shutil.copytree(FIXTURE, out / "ckpt")
    # the train CLI resumes the JAX run (epoch 2, its update count) for one
    # step, saves its own file and rotates the JAX directories away
    state = torch_train.main(["--cfg_file", CFG, "--device", "cpu", "--epochs", "3",
                              "--batch_size", "2", "--workers", "0", "--num_epochs_to_eval",
                              "0", "--max_ckpt_save_num", "1"] + FEWER)
    assert state.step == jax_ckpt_count(2) + 1
    assert [p.name for p in (out / "ckpt").iterdir()] == ["checkpoint_epoch_3"]
    assert (out / "ckpt" / "checkpoint_epoch_3").is_file()
    (log,) = out.glob("log_train_*.txt")
    assert f"resumed from epoch 2 it {jax_ckpt_count(2)}" in log.read_text()

    src = FIXTURE / "checkpoint_epoch_2"
    result = torch_test.main(["--cfg_file", CFG, "--device", "cpu", "--batch_size", "2",
                              "--ckpt", str(src)] + FEWER)
    assert 0 <= result["mAP"] <= 1
    (log,) = (out / "eval").glob("log_eval_*.txt")
    assert "loaded 652 of 652 model entries" in log.read_text()

    dst = tmp_path / "init.pth"
    torch_ckpt_surgery.main(["--src", str(src), "--dst", str(dst), "--cfg_file", CFG])
    payload = torch.load(dst, weights_only=True)
    sd = payload["model_state"]
    assert payload["epoch"] == 2 and payload["optimizer_state"]["count"] == jax_ckpt_count(2)
    want = state_dict_from_jax(port_model[1], jax_ckpt.read_checkpoint(src)["state"])
    key = "backbone_3d.conv1_0.bn1.running_var"
    assert torch.equal(sd[key], want[key]) and torch.equal(sd["radar_" + key], want[key])
    assert not torch.equal(want["radar_" + key], want[key])
