"""Where the port's float32 gradient of the dense LiDAR teacher parts from
the JAX package's, and why: a probe, not a test.

Run from the repository root (CPU, about two minutes):

    JAX_PLATFORMS=cpu python -m tests.torch_dense_grad_probe [--weights init|tests]
        [--every_leaf]

``tests/torch_dense_case.py``'s teacher topology (``pillarnet.yaml``'s
model at grid 96, the same seeded batch), with the JAX package's own
initializer (``--weights init``, the reference's initialization) or the
weights the tests draw (``--weights tests``), one train forward and
backward in each package. It prints:

1. the loss; the train forward's features, port against JAX (rel-L2); the
   loss's gradient with respect to the predictions;
2. the gradient of each parameter, port against JAX, the worst ten (every
   one with ``--every_leaf``); the conv biases that feed a train-mode
   BatchNorm (true gradient 0) apart;
3. every train-mode BatchNorm node of the port's backward (each
   ``MaskedBatchNorm`` and ``BatchNormTorch``, and the head's merged
   subhead BatchNorm with its ReLU, also per subhead) alone, on the input
   and the cotangent that this run gave it: the port's float32 dx, dscale,
   dbias (as the run computed them) against the same node's backward in
   float64, and for the head's two BatchNorms the JAX package's float32
   (``flax``'s ``nn.BatchNorm``) too. ``kept`` is
   ``|dx| / |dy * scale / sigma|``, the share of the cotangent that the
   backward keeps once it takes out the mean and the projection on the
   normalized input (small would mean cancellation);
4. the LiDAR head alone in both packages on the same input and the same
   cotangent, and the port's head alone on the port's
   ``spatial_features_2d``, on the JAX package's (jitted, and op by op:
   another float32 order), on the port's own
   computed without oneDNN (another float32 order of the convolutions), on
   the port's plus seeded noise of the norm of its difference to JAX's, and
   on the port's plus that difference with seeded signs: how far the
   head's gradient moves with its input's float32 differences; along the
   noise, in steps; and the head's ReLU gates that the port's input and
   JAX's set differently.
"""

import argparse
import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from radardistill_tpu.models import compute_training_loss as jax_training_loss
from radardistill_tpu_torch.models import compute_training_loss
from radardistill_tpu_torch.models import center_head as ch
from radardistill_tpu_torch.models.layers import BatchNormTorch, MaskedBatchNorm
from tests.torch_dense_case import PREDS, ZERO_GRAD, make_setup

FEATURES = ("x_conv4", "x_conv5", "spatial_features_2d", "spatial_features_2d_8x")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bn64(x, gy, scale, bias, eps, mask=None, relu=False):
    """dx, dscale, dbias of a train-mode BatchNorm (statistics over the rows
    of ``mask`` when given, biased variance) in float64, and its ``kept``."""
    x = x.detach().double().requires_grad_()
    w = scale.detach().double().requires_grad_()
    b = bias.detach().double().requires_grad_()
    axes = tuple(range(x.dim() - 1))
    m = (torch.ones(x.shape[:-1], dtype=torch.float64) if mask is None
         else mask.double())
    n = torch.clamp(m.sum(), min=1.0)
    mean = (x * m[..., None]).sum(dim=axes) / n
    var = torch.clamp((x * x * m[..., None]).sum(dim=axes) / n - mean * mean, min=0.0)
    y = (x - mean) * torch.rsqrt(var + eps) * w + b
    y = torch.relu(y) if relu else y
    dx, dw, db = torch.autograd.grad(y, (x, w, b), gy.double())
    kept = dx.norm() / (gy.double() * w * torch.rsqrt(var + eps)).norm()
    return dx, dw, db, float(kept)


def _flax_bn(x, gy, scale, bias, eps, relu=False):
    """dx, dscale, dbias of flax's train-mode ``nn.BatchNorm`` in float32."""
    bn = flax.linen.BatchNorm(use_running_average=False, epsilon=eps)
    c = x.shape[-1]
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def f(x, s, b):
        y, _ = bn.apply({"params": {"scale": s, "bias": b}, "batch_stats": stats}, x,
                        mutable=["batch_stats"])
        return jax.nn.relu(y) if relu else y

    _, vjp = jax.vjp(f, *(jnp.asarray(t.detach().numpy()) for t in (x, scale, bias)))
    return [np.asarray(g) for g in vjp(jnp.asarray(gy.numpy()))]


def capture(model):
    """Hooks that keep, for each train-mode BatchNorm of the forward, its
    input, mask, output cotangent and input gradient; returns the list they
    fill and a function that removes them."""
    nodes, handles = [], []

    def on_bn(mod, args, out):
        if not mod.training:
            return
        x = args[0]
        node = dict(name=names[mod], x=x.detach(), mask=args[1] if len(args) > 1 else None,
                    eps=mod.eps, scale=getattr(mod, "weight", None))
        if isinstance(mod, BatchNormTorch):
            node["scale"], node["bias"] = mod.bn.weight, mod.bn.bias
        else:
            node["bias"] = mod.bias
        x.register_hook(lambda g: node.__setitem__("dx", g.detach()))
        out.register_hook(lambda g: node.__setitem__("gy", g.detach()))
        nodes.append(node)

    names = {m: n for n, m in model.named_modules()}
    for mod in model.modules():
        if isinstance(mod, (BatchNormTorch, MaskedBatchNorm)):
            handles.append(mod.register_forward_hook(on_bn))

    # the head's merged subhead BatchNorm (+ ReLU): its input h reaches
    # batch_stats (h.float() is h itself at float32), its output the tails
    head = {}
    stats, tail = ch.batch_stats, ch.StackedSubHead.tail

    def batch_stats(h):
        if h.requires_grad and "h" not in head:
            head["h"] = h.detach()
            h.register_hook(lambda g: head.__setitem__("dx", g.detach()))
        return stats(h)

    def tail_hook(self, hidden):
        if hidden.requires_grad:
            i = len(head.setdefault("tails", []))
            head["tails"].append(None)
            hidden.register_hook(lambda g: head["tails"].__setitem__(i, g.detach()))
        return tail(self, hidden)

    ch.batch_stats, ch.StackedSubHead.tail = batch_stats, tail_hook

    def remove():
        for h in handles:
            h.remove()
        ch.batch_stats, ch.StackedSubHead.tail = stats, tail

    return nodes, head, remove


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", choices=("init", "tests"), default="init")
    ap.add_argument("--every_leaf", action="store_true",
                    help="also print every parameter's rel-L2, in the model's order")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    setup = make_setup("teacher")
    cfg, pcfg, info, jm = setup["cfg"], setup["pcfg"], setup["info"], setup["jmodel"]
    geo = (info["class_names"], info["voxel_size"], info["point_cloud_range"])
    variables = setup["variables"]
    if args.weights == "init":
        variables = jax.tree.map(np.asarray, jax.jit(lambda k, b: jm.init(k, b, True))(
            jax.random.PRNGKey(0), setup["jbatch"]))
        variables = {k: variables[k] for k in ("params", "batch_stats")}
    from radardistill_tpu_torch.convert import load_jax_variables, state_dict_from_jax
    model = load_jax_variables(copy.deepcopy(setup["model"]), variables).train()
    setup_model = copy.deepcopy(model)  # its BN statistics before this run's forward

    # JAX: the loss, its gradient, and the gradient w.r.t. the predictions
    def loss_of(params, preds=None):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          setup["jbatch"], True, mutable=["batch_stats"])
        if preds is not None:
            out = dict(out, lidar_preds=preds)
        return jax_training_loss(cfg, out, *geo)[0], out

    @jax.jit
    def jax_side(params):
        (loss, out), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        dpreds = jax.grad(lambda p: loss_of(params, p)[0])(out["lidar_preds"])
        return loss, grads, dpreds, {k: out[k] for k in FEATURES}

    jloss, jgrads, jdpreds, jfeats = jax.tree.map(np.asarray, jax_side(variables["params"]))

    nodes, head, remove = capture(model)
    out = model(setup["tbatch"])
    preds = dict(out["lidar_preds"])
    for v in preds.values():
        v.retain_grad()
    loss, _ = compute_training_loss(pcfg, out, *geo)
    loss.backward()
    remove()
    tgrads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    want = state_dict_from_jax(model, {"params": jgrads})

    print(f"weights: {args.weights}; loss port {loss.item():.9g}, JAX {float(jloss):.9g}")
    print("train forward, port against JAX (rel-L2): " + ", ".join(
        f"{k} {_rel(out[k].detach().numpy(), jfeats[k]):.2e}" for k in FEATURES))
    print("d loss / d predictions, port against JAX (rel-L2): " + ", ".join(
        f"{k} {_rel(preds[k].grad.numpy(), jdpreds[k]):.2e}" if np.any(jdpreds[k])
        else f"{k} 0 in JAX, max |port| {float(preds[k].grad.abs().max()):.1e}" for k in PREDS))
    rels = sorted(((_rel(g.numpy(), want[n].numpy()), n) for n, g in tgrads.items()
                   if not ZERO_GRAD.fullmatch(n)), reverse=True)
    norm = float(np.sqrt(sum((want[n].double() ** 2).sum() for n in tgrads)))
    zero = max(float(tgrads[n].abs().max()) for n in tgrads if ZERO_GRAD.fullmatch(n))
    print(f"gradients, port against JAX: {len(rels)} leaves (and {len(tgrads) - len(rels)} "
          f"conv biases before a train-mode BatchNorm, true gradient 0: at most "
          f"{zero / norm:.1e} of the global norm), worst rel-L2:")
    for r, n in rels[:10]:
        print(f"  {r:.3e}  {n}")
    if args.every_leaf:
        for n, g in tgrads.items():
            print(f"    {_rel(g.numpy(), want[n].numpy()):.3e}  {n}")

    print("train-mode BatchNorm nodes alone, same inputs and cotangent "
          "(rel-L2 of dx, dscale, dbias against float64; kept = |dx| / |dy scale / sigma|):")
    rows = []
    for node in nodes:
        dx64, dw64, db64, kept_share = _bn64(node["x"], node["gy"], node["scale"], node["bias"],
                                             node["eps"], node["mask"])
        dw, db = tgrads.get(_param_name(model, node["scale"])), \
            tgrads.get(_param_name(model, node["bias"]))
        rows.append((_rel(node["dx"].numpy(), dx64.numpy()), node["name"], kept_share,
                     _rel(dw.numpy(), dw64.numpy()) if dw is not None else float("nan"),
                     _rel(db.numpy(), db64.numpy()) if db is not None else float("nan"),
                     node))
    gy = torch.cat(head["tails"], dim=-1)
    subs = [getattr(model.dense_head, n) for n in model.dense_head.sub_names]
    scale = torch.cat([s.bn_0.bn.weight for s in subs])
    bias = torch.cat([s.bn_0.bn.bias for s in subs])
    eps = subs[0].bn_0.eps
    dx64, dw64, db64, kept_share = _bn64(head["h"], gy, scale, bias, eps, relu=True)
    dw = torch.cat([tgrads[_param_name(model, s.bn_0.bn.weight)] for s in subs])
    db = torch.cat([tgrads[_param_name(model, s.bn_0.bn.bias)] for s in subs])
    head_row = (_rel(head["dx"].numpy(), dx64.numpy()), "dense_head (merged subhead BN + ReLU)",
                kept_share, _rel(dw.numpy(), dw64.numpy()), _rel(db.numpy(), db64.numpy()), None)
    for r in sorted(rows + [head_row], key=lambda r: -r[0]):
        print(f"  port f32: dx {r[0]:.3e}, dscale {r[3]:.3e}, dbias {r[4]:.3e}; kept "
              f"{r[2]:.3e}  {r[1]}")
    # the JAX package's float32 on the head's two BatchNorms alone
    jdx, jdw, jdb = _flax_bn(head["h"], gy, scale, bias, eps, relu=True)
    print(f"  JAX f32 (flax nn.BatchNorm): dx {_rel(jdx, dx64.numpy()):.3e}, dscale "
          f"{_rel(jdw, dw64.numpy()):.3e}, dbias {_rel(jdb, db64.numpy()):.3e}  "
          f"dense_head (merged subhead BN + ReLU); port f32 against JAX f32: dx "
          f"{_rel(head['dx'].numpy(), jdx):.3e}")
    # the merged BatchNorm per subhead (its channels)
    h64 = head["h"].double()
    sigma = torch.sqrt(h64.var(dim=(0, 1, 2), unbiased=False) + eps)
    pre = (h64 - h64.mean(dim=(0, 1, 2))) / sigma * scale.double() + bias.double()
    g_pre = gy.double() * (pre > 0)
    c = scale.shape[0] // len(subs)
    for i, name in enumerate(model.dense_head.sub_names):
        sl = slice(i * c, (i + 1) * c)
        d64 = dx64[..., sl].numpy()
        kept_g = float(dx64[..., sl].norm() / (g_pre[..., sl] * scale[sl].double()
                                                / sigma[sl]).norm().clamp(min=1e-300))
        print(f"    {name:9s} channels: dx port {_rel(head['dx'][..., sl].numpy(), d64):.3e}, "
              f"JAX {_rel(jdx[..., sl], d64):.3e}, port against JAX "
              f"{_rel(head['dx'][..., sl].numpy(), jdx[..., sl]):.3e}; dbias port "
              f"{_rel(db[sl].numpy(), db64[sl].numpy()):.3e}, JAX "
              f"{_rel(jdb[sl], db64[sl].numpy()):.3e}; kept {kept_g:.3e}")
    head_alone(setup_model, jm, variables, out["spatial_features_2d"].detach(), jdpreds)
    # the port's head alone on the two packages' inputs (the same cotangent)
    grads = []
    x0 = out["spatial_features_2d"].detach()
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(0))
    diff = x0 - torch.from_numpy(jfeats["spatial_features_2d"])
    noisy = x0 + noise * (diff.norm() / noise.norm())
    flipped = x0 + diff.abs() * torch.sign(noise)  # the difference, its signs drawn
    for x in (x0, x0 - diff, noisy, flipped):
        hmod = copy.deepcopy(setup_model.dense_head).train()
        preds = hmod(x)
        torch.autograd.backward([preds[k] for k in preds],
                                [torch.from_numpy(np.asarray(jdpreds[k])) for k in preds])
        grads.append({n: p.grad for n, p in hmod.named_parameters()})
    # the port's own forward in another float32 order: convolutions without oneDNN
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        other = copy.deepcopy(setup_model).train()(setup["tbatch"])["spatial_features_2d"]
    hmod = copy.deepcopy(setup_model.dense_head).train()
    p4 = hmod(other)
    torch.autograd.backward([p4[k] for k in p4],
                            [torch.from_numpy(np.asarray(jdpreds[k])) for k in p4])
    grads.append({n: p.grad for n, p in hmod.named_parameters()})
    # the JAX package's own forward in another float32 order: op by op, no jit
    eager, _ = jm.apply(variables, setup["jbatch"], True, mutable=["batch_stats"])
    eager = torch.from_numpy(np.asarray(eager["spatial_features_2d"]))
    hmod = copy.deepcopy(setup_model.dense_head).train()
    p5 = hmod(eager)
    torch.autograd.backward([p5[k] for k in p5],
                            [torch.from_numpy(np.asarray(jdpreds[k])) for k in p5])
    grads.append({n: p.grad for n, p in hmod.named_parameters()})
    inputs = [x0, x0 - diff, noisy, flipped, other, eager]
    steps = []
    for t in (1e-4, 1e-3, 1e-2, 1e-1):
        hmod = copy.deepcopy(setup_model.dense_head).train()
        pt = hmod(x0 + t * (noisy - x0))
        torch.autograd.backward([pt[k] for k in pt],
                                [torch.from_numpy(np.asarray(jdpreds[k])) for k in pt])
        moved = _rel(hmod.shared_conv.conv.weight.grad, grads[0]["shared_conv.conv.weight"])
        steps.append(f"{t:g}: {moved:.2e}")
    print("the port's head alone on its input plus t x the seeded noise, shared_conv.conv.weight "
          "against t = 0: " + ", ".join(steps) + f", 1: "
          f"{_rel(grads[2]['shared_conv.conv.weight'], grads[0]['shared_conv.conv.weight']):.2e}")
    # the ReLU gates of the head that the two inputs set differently
    tail, gates = ch.StackedSubHead.tail, []
    ch.StackedSubHead.tail = lambda self, hidden: (gates.append(hidden > 0), tail(self, hidden))[1]
    try:
        for x in (x0, x0 - diff):
            hm = copy.deepcopy(setup_model.dense_head).train()
            with torch.no_grad():
                gates.append(hm.shared_bn(hm.shared_conv(x)) > 0)
                hm(x)
    finally:
        ch.StackedSubHead.tail = tail
    n = len(gates) // 2
    names = ["shared"] + list(setup_model.dense_head.sub_names)
    print("the head's ReLU gates that the port's input and JAX's set differently: " + ", ".join(
        f"{name} {int((a != b).sum())} of {a.numel()}"
        for name, a, b in zip(names, gates[:n], gates[n:])))
    for i, what in ((1, "JAX's"), (4, "the port's own without oneDNN"),
                    (2, "the port's plus seeded noise of JAX's distance"),
                    (3, "the port's plus the difference to JAX's, its signs drawn")):
        print(f"the port's head alone on the port's spatial_features_2d and on {what} "
              f"({_rel(inputs[i].numpy(), x0.numpy()):.2e} apart), same "
              "cotangent: " + ", ".join(
                  f"{n} {_rel(grads[0][n].numpy(), grads[i][n].numpy()):.2e}"
                  for n in ("shared_conv.conv.weight", "shared_bn.bn.weight",
                            "hm.conv_0.conv.weight", "center.conv_0.conv.weight")))
    shared = next(r[5] for r in rows if r[1] == "dense_head.shared_bn")
    dx64, dw64, db64, _ = _bn64(shared["x"], shared["gy"], shared["scale"], shared["bias"],
                                shared["eps"])
    jdx, jdw, jdb = _flax_bn(shared["x"], shared["gy"], shared["scale"], shared["bias"],
                             shared["eps"])
    x64 = shared["x"].double().reshape(-1, shared["x"].shape[-1])
    ratio = (x64.std(dim=0, unbiased=False) / x64.pow(2).mean(dim=0).sqrt()).sort().values
    print(f"  dense_head.shared_bn input: per-channel std / rms, smallest {ratio[0]:.2e}, "
          f"{ratio[1]:.2e}, {ratio[2]:.2e}, median {ratio[len(ratio) // 2]:.2e}")
    print(f"  JAX f32 (flax nn.BatchNorm): dx {_rel(jdx, dx64.numpy()):.3e}, dscale "
          f"{_rel(jdw, dw64.numpy()):.3e}, dbias {_rel(jdb, db64.numpy()):.3e}  "
          f"dense_head.shared_bn; port f32 against JAX f32: dx "
          f"{_rel(shared['dx'].numpy(), jdx):.3e}")


def head_alone(model, jm, variables, x, jdpreds):
    """The LiDAR head's train forward and backward alone in both packages, on
    the same input (the port's ``spatial_features_2d``) and the same
    cotangent (the JAX package's gradient of the loss with respect to the
    predictions): the gradient of each head parameter and of the input."""
    def head(params, x):
        preds, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, True,
                            method=lambda m, x, t: m.dense_head(x, t), mutable=["batch_stats"])
        return preds

    params = jax.tree.map(jnp.asarray, variables["params"])
    preds, vjp = jax.vjp(head, params, jnp.asarray(x.numpy()))
    jgp, jgx = vjp({k: jnp.asarray(jdpreds[k]) for k in preds})
    from radardistill_tpu_torch.convert import state_dict_from_jax
    want = state_dict_from_jax(model, {"params": jax.tree.map(np.asarray, jgp)})
    hmod = copy.deepcopy(model.dense_head).train()
    for p in hmod.parameters():
        p.grad = None
    tx = x.clone().requires_grad_()
    tpreds = hmod(tx)
    torch.autograd.backward([tpreds[k] for k in tpreds],
                            [torch.from_numpy(np.asarray(jdpreds[k])) for k in tpreds])
    print("the head alone, same input and cotangent, port against JAX (rel-L2): "
          f"preds hm {_rel(tpreds['hm'].detach().numpy(), preds['hm']):.2e}, "
          f"d input {_rel(tx.grad.numpy(), jgx):.3e}")
    for n, p in hmod.named_parameters():
        if not ZERO_GRAD.fullmatch("dense_head." + n):
            print(f"    {_rel(p.grad.numpy(), want['dense_head.' + n].numpy()):.3e}  "
                  f"dense_head.{n}")


def _param_name(model, p):
    if p is None:
        return None
    return next(n for n, q in model.named_parameters() if q is p)


if __name__ == "__main__":
    main()
