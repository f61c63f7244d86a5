"""K1, the fused int8 conv link, and the int8 helpers around it, against the
JAX package; and (on a card) the CUDA kernel on each of its routes (the
``wgmma`` conv mainloop, the ``mma.sync`` resident and streamed variants)
against its plain version.

The JAX side reaches the Pallas ``_block_kernel`` in interpret mode on its own
(``pallas_conv_block._interpret``), as ``tests/test_conv_block_v2.py`` runs
it. Both sides get identical ``kq, sw, bias, gt, sh, bound`` made with numpy
from a seed. On the CPU the port takes its plain version.

Tolerances. The integer part (the int32 accumulator, ``ksum``) is exact on
both sides, so the int8 codes can differ only where the float32 epilogue
rounds differently: XLA's CPU backend may contract ``acc * alpha + beta``
into one fused multiply-add where PyTorch rounds twice, which moves ``y`` by
an ulp and flips a code only where ``y * s_out`` lands within an ulp of a
half. The tests allow a code difference of at most 1 on at most 1e-3 of the
entries and print the measured share (0 in every case here when this was
written); float (``deq_out``) outputs agree to 1e-6 relative to the largest
value. The exact helpers (quantized kernels, ``q8`` codes, packing) are held
bit-equal; float helpers to 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.ops import pallas_conv_block as jcb
from radardistill_tpu_torch.models import layers
from radardistill_tpu_torch.ops import conv_block as cb

CODE_SHARE_LIMIT = 1e-3


def _link(seed, b=2, h=16, w=16, c=32, co=32, kh=3, nph=1, zero=0.0, with_res=False):
    """numpy inputs of one link: a carry, quantized kernel pieces, the BN
    affine, a compact mask and an optional residual carry."""
    rng = np.random.RandomState(seed)
    k = rng.randn(kh, kh, c, co).astype(np.float32) * 0.1
    sw = np.maximum(np.abs(k).max(axis=(0, 1, 2)), 1e-12) / np.float32(127.0)
    kq = np.round(k / sw).astype(np.int8)
    link = dict(
        xq=rng.randint(-127, 128, (b, h, w, c)).astype(np.int8), bnd=np.float32(2.0), zero=zero,
        kq=kq, sw=sw.astype(np.float32),
        bias=(rng.randn(co) * 0.1).astype(np.float32),
        gt=(rng.rand(co) + 0.5).astype(np.float32),
        sh=(rng.randn(co) * 0.1).astype(np.float32), bound=np.float32(3.0),
        mask=(rng.rand(b, h, w, nph) > 0.3).astype(np.int8), res=None)
    if with_res:
        link["res"] = (rng.randint(-127, 128, (b, h, w, co)).astype(np.int8), np.float32(1.5), 127.0)
    return link


def _run_jax(link, deq_out=None):
    j = jnp.asarray
    res = link["res"] and (j(link["res"][0]), j(link["res"][1]), link["res"][2])
    return jcb.int8_block(
        (j(link["xq"]), j(link["bnd"]), link["zero"]), j(link["kq"]), j(link["sw"]),
        j(link["bias"]), j(link["gt"]), j(link["sh"]), j(link["bound"]), j(link["mask"]),
        res=res, deq_out=deq_out)


def _run_torch(link, deq_out=None, device="cpu", block=cb.conv_block):
    t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    res = link["res"] and (t(link["res"][0]), t(link["res"][1]), link["res"][2])
    return cb.int8_block_conv_v2(
        (t(link["xq"]), t(link["bnd"]), link["zero"]), t(link["kq"]), t(link["sw"]),
        t(link["bias"]), t(link["gt"]), t(link["sh"]), t(link["bound"]), t(link["mask"]),
        res=res, deq_out=deq_out, block=block)


LINK_CASES = [
    dict(kh=3, zero=0.0),
    dict(kh=3, zero=127.0),
    dict(kh=2, zero=127.0),
    dict(kh=3, zero=127.0, nph=4, c=128, co=128, h=8, with_res=True),
    dict(kh=3, zero=0.0, nph=4, c=64, co=64, with_res=True),
    dict(kh=2, zero=127.0, c=128, co=64, with_res=False, w=24),
]


@pytest.mark.parametrize("case", LINK_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_link_codes_match_pallas(case):
    link = _link(0, **case)
    qj, bj, zj = _run_jax(link)
    qt, bt, zt = _run_torch(link)
    qj = np.asarray(qj).astype(np.int32)
    diff = np.abs(qt.numpy().astype(np.int32) - qj)
    share = float((diff != 0).mean())
    print(f"share of differing codes: {share:.2e}")
    assert diff.max() <= 1 and share <= CODE_SHARE_LIMIT
    assert float(bt) == float(bj) and zt == zj == 127.0
    assert (qj > -127).mean() > 0.1  # the case exercises the code range


@pytest.mark.parametrize("case", [dict(kh=3, zero=127.0, nph=4, c=64, co=64, with_res=True),
                                  dict(kh=2, zero=127.0, c=128, co=64)],
                         ids=["kh3-res-nph4", "kh2-terminus"])
def test_link_float_out_matches_pallas(case):
    link = _link(1, **case)
    yj = np.asarray(_run_jax(link, deq_out=jnp.float32))
    yt = _run_torch(link, deq_out=torch.float32).numpy()
    assert yt.dtype == np.float32 and yt.shape == yj.shape
    assert np.abs(yt - yj).max() <= 1e-6 * np.abs(yj).max()


def test_link_on_cpu_takes_plain_version_without_counting():
    before = cb.conv_block.launches
    _run_torch(_link(2, h=8, w=8))
    assert cb.conv_block.launches == before


def test_plain_accumulator_is_exact_beyond_float32():
    """|acc| passes 2**24 at 9 * 128 channels of +-127: a float32 conv would
    round there; the plain version's integer accumulation does not."""
    xq = torch.full((1, 4, 4, 128), 127, dtype=torch.int8)
    kq = torch.full((3, 3, 128, 16), 127, dtype=torch.int8)
    kq[0, 0, 0, 0] = 126  # an odd total
    acc = cb.int_conv_exact(xq, kq, 1, ((1, 1), (1, 1)))
    assert acc.dtype == torch.int32
    assert int(acc[0, 1, 1, 0]) == 9 * 128 * 127 * 127 - 127
    assert int(acc[0, 1, 1, 0]) > 2 ** 24 and int(acc[0, 1, 1, 0]) % 2 == 1


def test_conv_block_rejects_what_it_does_not_take():
    link = _link(3, h=8, w=8)
    t = torch.as_tensor
    ab = torch.zeros(8, 32)
    with pytest.raises(TypeError):
        cb.conv_block(t(link["xq"]).float(), t(link["kq"]), ab, t(link["mask"]))
    with pytest.raises(ValueError):
        cb.conv_block(t(link["xq"]), t(link["kq"]), ab[:, :16], t(link["mask"]))
    with pytest.raises(ValueError):
        cb.conv_block(t(link["xq"]), t(link["kq"])[:2], ab, t(link["mask"]))


# ------------------------------------------------------------ int8 helpers


@pytest.fixture
def jlayers():
    """The JAX package's layers (flax): imported here, not at the top, so that
    the card-only legs below still collect on a machine without flax."""
    return pytest.importorskip("radardistill_tpu.models.layers")


def test_int8_qkernel_matches_jax(jlayers):
    k = np.random.RandomState(4).randn(3, 3, 24, 40).astype(np.float32) * 0.2
    kqj, swj = jlayers.int8_qkernel(jnp.asarray(k))
    kqt, swt = layers.int8_qkernel(torch.from_numpy(k))
    np.testing.assert_array_equal(kqt.numpy(), np.asarray(kqj))
    np.testing.assert_allclose(swt.numpy(), np.asarray(swj), rtol=1e-6)


@pytest.mark.parametrize("zero", [0.0, 127.0])
def test_q8_deq8_match_jax(jlayers, zero):
    rng = np.random.RandomState(5)
    y = (rng.rand(4, 9, 33) * 5.0 - (0.0 if zero else 2.5)).astype(np.float32)
    bound = np.float32(4.0)
    qj = jlayers.q8(jnp.asarray(y), jnp.asarray(bound), zero)
    qt = layers.q8(torch.from_numpy(y), torch.tensor(bound), zero)
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    dj = jlayers.deq8(qj, jnp.asarray(bound), zero)
    dt = layers.deq8(qt, torch.tensor(bound), zero)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


@pytest.mark.parametrize("zero,stride,padding", [(127.0, 1, ((1, 0), (1, 0))),
                                                 (0.0, 1, ((1, 1), (1, 1))),
                                                 (127.0, 2, ((1, 1), (1, 1)))])
def test_int8_conv_affine_matches_jax(jlayers, zero, stride, padding):
    kh = 2 if padding == ((1, 0), (1, 0)) else 3
    link = _link(6, c=64, co=32, kh=kh)
    j, t = jnp.asarray, torch.as_tensor
    i32j = jlayers.int8_conv_i32(j(link["xq"]), j(link["kq"]), stride, padding)
    i32t = layers.int8_conv_i32(t(link["xq"]), t(link["kq"]), stride, padding)
    assert i32t.dtype == torch.int32
    np.testing.assert_array_equal(i32t.numpy(), np.asarray(i32j))
    yj = jlayers.int8_conv_affine((j(link["xq"]), j(link["bnd"]), zero), j(link["kq"]),
                                  j(link["sw"]), None, j(link["gt"]), j(link["sh"]), stride, padding)
    yt = layers.int8_conv_affine((t(link["xq"]), t(link["bnd"]), zero), t(link["kq"]),
                                 t(link["sw"]), None, t(link["gt"]), t(link["sh"]), stride, padding)
    assert np.abs(yt.numpy() - np.asarray(yj)).max() <= 1e-6 * np.abs(np.asarray(yj)).max()


def test_bn_affine_and_max_pool_mask_match_jax(jlayers):
    rng = np.random.RandomState(7)
    bn = layers.MaskedBatchNorm(16)
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean"):
            getattr(bn, name).copy_(torch.from_numpy(rng.randn(16).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.rand(16).astype(np.float32) + 0.5))
        gt, sh, bound = bn.affine()
    variables = {"params": {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy()},
                 "batch_stats": {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}}
    gj, sj, bj = jlayers.MaskedBatchNorm().apply(
        variables, jnp.zeros((1, 16)), None, False, affine=True)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6)
    np.testing.assert_allclose(sh.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(bound), float(bj), rtol=1e-6)
    mask = rng.rand(2, 20, 28) > 0.9
    np.testing.assert_array_equal(
        layers.max_pool_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jlayers.max_pool_mask(jnp.asarray(mask))))


# ------------------------------------------------------- card-only (gpu)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


# links the wgmma route takes (C and Co multiples of 128): both windows, 1, 2
# and 4 mask phases, zero 0 and 127 (zpad 0 and -127: the border correction),
# with and without a residual, an H x W that is no multiple of the 4 x 64
# tile, two chunks of C and two tiles of Co
WGMMA_CASES = [
    dict(kh=3, zero=0.0, c=128, co=128, h=19, w=70),
    dict(kh=3, zero=127.0, nph=4, c=128, co=128, h=19, w=70, with_res=True),
    dict(kh=2, zero=127.0, c=128, co=128, h=19, w=70, with_res=True),
    dict(kh=2, zero=0.0, nph=4, c=256, co=128, h=9, w=13),
    dict(kh=3, zero=127.0, c=256, co=256, h=19, w=70, with_res=True),
    dict(kh=2, zero=127.0, nph=4, c=256, co=256, h=8, w=64),
    dict(kh=3, zero=127.0, nph=2, c=256, co=256, h=5, w=130),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", LINK_CASES + [dict(kh=3, zero=127.0, h=19, w=37, c=64, co=16)]
                         + WGMMA_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("deq_out", [None, torch.float32, torch.bfloat16])
def test_kernel_equals_plain_on_card(cuda, case, deq_out):
    """Every output equal to the plain version's on the route the dispatch
    rule gives the link, and that route's counter moved."""
    link = _link(8, **case)
    kh, _, c, co = link["kq"].shape
    route = cb.route_of(kh, c, co, link["mask"].shape[-1], deq_out or torch.int8)
    if deq_out != torch.float32 and ((c % 128 == 0 and co % 128 == 0)
                                     or (co == 64 and c % 64 == 0)):
        assert route == "wgmma"
    else:  # float32 out, or C or Co off the wgmma route's grid: mma.sync
        assert route == ("streamed" if co == 256 else "resident")
    before, routes = cb.conv_block.launches, dict(cb.conv_block.route_launches)
    got = _run_torch(link, deq_out, cuda)
    assert cb.conv_block.launches == before + 1
    assert cb.conv_block.route_launches == {**routes, route: routes[route] + 1}
    want = _run_torch(link, deq_out, cuda, block=cb.conv_block_plain)
    torch.cuda.synchronize()
    if deq_out is None:
        got, want = got[0], want[0]
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["resident", "streamed"])
def test_mma_sync_routes_equal_the_wgmma_route_on_card(cuda, variant):
    """Forced onto the mma.sync kernel, a link the rule sends to wgmma gives
    the same codes."""
    link = _link(10, kh=3, zero=127.0, nph=4, c=128, co=128, h=19, w=70, with_res=True)
    forced = lambda *a, **k: cb.conv_block(*a, variant=variant, **k)  # noqa: E731
    got = _run_torch(link, None, cuda, block=forced)[0]
    assert torch.equal(got, _run_torch(link, None, cuda)[0])


@pytest.mark.gpu
def test_kernel_raises_on_shapes_it_does_not_take(cuda):
    link = _link(9, c=48, co=32, h=8, w=8)  # C not a multiple of 32
    with pytest.raises(ValueError):
        _run_torch(link, None, cuda)
    link = _link(9, c=512, co=128, h=8, w=8)  # weight over the shared memory
    resident = lambda *a, **k: cb.conv_block(*a, variant="resident", **k)  # noqa: E731
    with pytest.raises(ValueError):
        _run_torch(link, None, cuda, block=resident)
    # the streamed variant takes it
    got = _run_torch(link, None, cuda)[0]
    assert torch.equal(got, _run_torch(link, None, cuda, block=cb.conv_block_plain)[0])
    link = _link(9, c=32, co=48, h=8, w=8)  # Co 48: no tile of either variant
    with pytest.raises(ValueError):
        _run_torch(link, None, cuda)
    # the wgmma route, forced: C 64 into Co 128, C 96 or Co 32, a float32 output
    wgmma = lambda *a, **k: cb.conv_block(*a, variant="wgmma", **k)  # noqa: E731
    for case, deq_out in ((dict(c=64, co=128), None), (dict(c=96, co=64), None),
                          (dict(c=64, co=32), None), (dict(c=128, co=128), torch.float32),
                          (dict(c=64, co=64), torch.float32)):
        before = dict(cb.conv_block.route_launches)
        with pytest.raises(ValueError):
            _run_torch(_link(9, h=8, w=8, **case), deq_out, cuda, block=wgmma)
        assert cb.conv_block.route_launches == before
    with pytest.raises(ValueError):
        _run_torch(_link(9, h=8, w=8), None, cuda,
                   block=lambda *a, **k: cb.conv_block(*a, variant="tiled", **k))
