"""K8, P1 and P2 of the port against the JAX package's kernels and tools, CPU.

On the CPU a wrapper takes its plain PyTorch version; the JAX side runs its
Pallas kernels in interpret mode. Inputs come from a numpy seed.

- K8 ``gather_rows_windowed`` / ``window_overflow``: the cases of
  ``tests/test_pallas_expand.py`` (four windows, the span violation, the
  full-table window) and random windows that are too small: rows bit-equal,
  counts equal.
- P1 ``conv_probe``: ``conv`` against ``conv3x3_pallas`` and
  ``conv3x3_shiftout`` of ``tools/pallas_conv_proto.py``; ``dots`` and ``int8``
  against that file's kernel bodies ``_kernel_dots``, ``_kernel_int8`` and
  ``_kernel_int8_n512``, each wrapped here in a ``pallas_call`` like the one
  its ``main_*`` builds, at H 16, W 24, C 8-32. float32 within 1e-5 x
  max|ref| (summation order), int8 codes equal.
- P2 ``mma_rate``: against the formula of ``tools/mxu_rate.py`` (``kern``)
  evaluated with ``jnp``: bfloat16 within 1e-2 x max|ref| (one bfloat16
  rounding of a differently ordered float32 sum), float32 within 1e-5, int8
  against numpy's int32 sum, equal. The rotation ``round(A + r)`` the kernels
  form in registers (``probes.rotate_plain``), per type: bfloat16 and int8
  bit-equal to ``mma_rate_plain``'s and to the formula's add on every value
  of the type; TF32 the float32 add rounded to nearest, ties away from zero;
  and the eight products of the rotated A against both, on small shapes.

The card-only twins (marker ``gpu``) hold each CUDA kernel against its plain
version at small shapes, and P2's ``wgmma`` route at every case of its rate
table; ``chip_smoke.py`` does so at the production shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from radardistill_tpu.ops import pallas_expand as jexp
from radardistill_tpu_torch.ops import expand, probe_bench, probes
from tools import pallas_conv_proto as proto

BLK = 512
PAD = -(2 ** 30)  # the segment-pad sentinel of the JAX tests


# ----------------------------------------------------------------------- K8


def _windowed_case(n_win, r, seed, c=24, widen=0):
    """The generator of ``tests/test_pallas_expand.py``: 6 blocks, each with a
    random number of sorted entries inside a span of n_win - 1 blocks (plus
    ``widen`` blocks, to break the window)."""
    rng = np.random.RandomState(seed)
    m = 6 * BLK
    table = rng.randn(r, c).astype(np.float32)
    idx = np.full((m,), PAD, np.int32)
    for blk in range(m // BLK):
        k = rng.randint(0, BLK + 1)
        if not k:
            continue
        cells = np.sort(rng.choice(BLK, k, replace=False)) + blk * BLK
        lo = rng.randint(0, max(r - 1, 1))
        hi = min(lo + (n_win - 1 + widen) * BLK - 1, r - 1)
        idx[cells] = np.sort(rng.randint(lo, hi + 1, size=k))
    return table, idx


def _k8_both(table, idx, n_win):
    jt, ji = jnp.asarray(table), jnp.asarray(idx)
    want = np.asarray(jexp.gather_rows_windowed(jt, ji, n_win, interpret=True))
    want_n = int(jexp.window_overflow(ji, table.shape[0], n_win))
    tt, ti = torch.from_numpy(table), torch.from_numpy(idx)
    got, got_n = expand.gather_rows_windowed(tt, ti, n_win)
    assert got_n.dtype == torch.int32 and int(got_n) == want_n
    assert int(expand.window_overflow(ti, table.shape[0], n_win)) == want_n
    np.testing.assert_array_equal(got.numpy(), want)
    return got, want_n


@pytest.mark.parametrize("n_win,r", [(2, 700), (4, 1800), (8, 4096), (3, 300)])
def test_gather_rows_windowed_matches_pallas(n_win, r):
    table, idx = _windowed_case(n_win, r, seed=n_win)
    got, n_over = _k8_both(table, idx, n_win)
    assert n_over == 0
    # with no overflow the window is invisible: the plain unwindowed gather
    plain = expand.expand_rows_plain(torch.from_numpy(table), torch.from_numpy(idx).clamp(0))
    ok = torch.from_numpy((idx >= 0) & (idx < r))
    assert torch.equal(got, plain * ok[:, None])


@pytest.mark.parametrize("n_win,r", [(2, 4096), (3, 1800), (1, 700)])
def test_gather_rows_windowed_too_small_a_window_matches_pallas(n_win, r):
    """Entries beyond the window come out as zero rows on both sides and are
    counted alike."""
    table, idx = _windowed_case(n_win, r, seed=10 + n_win, widen=2)
    got, n_over = _k8_both(table, idx, n_win)
    assert n_over > 0
    dropped = (got == 0).all(dim=1) & torch.from_numpy((idx >= 0) & (idx < r))
    assert int(dropped.sum()) >= n_over  # (a real row of zeros has measure zero)


def test_gather_rows_windowed_span_violation_is_counted():
    r, c, n_win = 4096, 8, 2
    table = np.ones((r, c), np.float32)
    idx = np.full((BLK,), PAD, np.int32)
    idx[0], idx[-1] = 0, 3000
    got, n_over = _k8_both(table, idx, n_win)
    assert n_over == 1 and got[0].sum() == c and got[-1].sum() == 0


def test_gather_rows_windowed_full_table_window():
    rng = np.random.RandomState(3)
    r, c = 900, 16
    n_win = -(-r // BLK) + 1
    table = rng.randn(r, c).astype(np.float32)
    idx = np.sort(rng.randint(-5, r + 5, size=4 * BLK)).astype(np.int32)
    idx = np.where(idx < 0, PAD, idx).astype(np.int32)
    _, n_over = _k8_both(table, idx, n_win)
    assert n_over == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_gather_rows_windowed_plain_is_a_bit_copy(dtype):
    table, idx = _windowed_case(3, 1800, seed=5, c=32)
    tt = torch.from_numpy(table * 20).to(dtype)
    got, n_over = expand.gather_rows_windowed(tt, torch.from_numpy(idx), 3)
    ok = (idx >= 0) & (idx < 1800)
    assert int(n_over) == 0 and got.dtype == dtype
    assert torch.equal(got[torch.from_numpy(ok)], tt[torch.from_numpy(idx[ok]).long()])
    assert not got[torch.from_numpy(~ok)].any()


def test_gather_rows_windowed_rejects_a_ragged_length():
    with pytest.raises(ValueError, match="multiple of 512"):
        expand.gather_rows_windowed(torch.zeros(8, 4), torch.zeros(100, dtype=torch.int32), 2)


def test_every_entry_point_signature_has_the_c_arity():
    """``cuda_lib.SIGNATURES`` gives each ``extern "C"`` entry point of the
    sources as many arguments as its declaration has (ctypes would pass a
    short list on, and the card alone would find out)."""
    import re

    from radardistill_tpu_torch.ops import cuda_lib

    seen = set()
    for src in cuda_lib.SOURCES:
        text = (cuda_lib.CSRC / src).read_text()
        for name, params in re.findall(r'extern "C" [^(]*?\b(rdt_\w+)\(([^)]*)\)', text):
            seen.add(name)
            assert len(cuda_lib.SIGNATURES[name]) == len(params.split(",")), name
    assert set(cuda_lib.SIGNATURES) <= seen


# the 14 gathers of the bs2 tap tables (chip_smoke.py's K8 phase): entries M
# and row bytes (bfloat16 channels x 2)
K8_GATHERS = {
    "tap1_fwd": (73728, 64), "tap1_bwd": (73728, 64), "dtap2_fwd": (147456, 64),
    "dtap2_bwd": (73728, 64), "tap2_fwd": (147456, 128), "tap2_bwd": (147456, 128),
    "dtap3_fwd": (175104, 128), "dtap3_bwd": (147456, 128), "tap3_fwd": (175104, 256),
    "tap3_bwd": (175104, 256), "dtap4_fwd": (147456, 256), "dtap4_bwd": (175104, 256),
    "tap4_fwd": (147456, 512), "tap4_bwd": (147456, 512)}


# csrc/gather_win.cu's launch geometry, mirrored here and held to the source
# by test_k8_mirror_is_the_kernel_source: a CTA of 128 threads moves 1024
# 16-byte vectors a round, 8 loads in flight a thread
K8_THREADS, K8_UNROLL = 128, 8
K8_CHUNK = K8_THREADS * K8_UNROLL


def _k8_slice_rows(row_bytes):
    """Mirror of ``slice_rows_for``: rows of a window block one CTA takes."""
    vpr, rows = row_bytes // 16, BLK
    while rows > 1 and rows * vpr > K8_CHUNK:
        rows //= 2
    return rows


def test_k8_mirror_is_the_kernel_source():
    from radardistill_tpu_torch.ops import cuda_lib

    text = (cuda_lib.CSRC / "gather_win.cu").read_text()
    for decl in (f"constexpr int kBlk = {BLK};", f"constexpr int kThreads = {K8_THREADS};",
                 f"constexpr int kUnroll = {K8_UNROLL};",
                 "constexpr int kChunk = kThreads * kUnroll;",
                 "while (rows > 1 && rows * vpr > kChunk) rows /= 2;"):
        assert decl in text, decl


def _k8_cover(m, row_bytes):
    """Mirror of ``csrc/gather_win.cu``'s launch: CTA -> (window block,
    slice), the CTA's vector loop (round c0, load k, thread) and the four
    entries of its block each thread loads and counts when they lie in its
    slice. Returns the hits of every output vector and of every entry's
    overflow test."""
    rows, vpr = _k8_slice_rows(row_bytes), row_bytes // 16
    slices = BLK // rows
    cta = np.arange(max(1, m // BLK * slices))  # one CTA when m == 0
    e0, r0 = (cta // slices) * BLK, (cta % slices) * rows
    e0, r0 = e0[e0 < m], r0[e0 < m]
    n_vec = rows * vpr
    i = (np.arange(0, n_vec, K8_CHUNK)[:, None, None]
         + np.arange(K8_UNROLL)[None, :, None] * K8_THREADS
         + np.arange(K8_THREADS)[None, None, :]).ravel()
    i = i[i < n_vec]
    vec = (((e0 + r0) * vpr)[:, None] + i[None, :]).ravel()
    e = np.arange(BLK)[None, :]  # thread t holds entries 4t .. 4t + 3
    mine = (e >= r0[:, None]) & (e < (r0 + rows)[:, None])
    return (np.bincount(vec, minlength=m * vpr), np.bincount((e0[:, None] + e)[mine], minlength=m))


def _k8_plan_ok(row_bytes):
    """The slice is a power of two dividing the block, and fits one round
    unless it is one row."""
    rows, vpr = _k8_slice_rows(row_bytes), row_bytes // 16
    assert 1 <= rows <= BLK and BLK % rows == 0
    assert rows == 1 or rows * vpr <= K8_CHUNK


@pytest.mark.parametrize("gather", K8_GATHERS)
def test_gather_plan_covers_every_row_and_entry_once_at_the_tap_gathers(gather):
    """At the 14 gathers of the tap tables every output vector is written by
    exactly one (CTA, round, load, thread), and every entry's overflow is
    counted by exactly one CTA."""
    m, row_bytes = K8_GATHERS[gather]
    _k8_plan_ok(row_bytes)
    vec_hits, entry_hits = _k8_cover(m, row_bytes)
    assert vec_hits.shape == (m * row_bytes // 16,) and (vec_hits == 1).all()
    assert entry_hits.shape == (m,) and (entry_hits == 1).all()


@pytest.mark.parametrize("row_bytes", [16, 32, 96, 1024, 65536])
@pytest.mark.parametrize("m", [0, BLK, 3 * BLK])
def test_gather_plan_covers_every_row_and_entry_once_at_other_widths(row_bytes, m):
    """The general instantiation's widths, the card tests' among them, one
    row a CTA for rows above 16 KB (several rounds), and no entries."""
    _k8_plan_ok(row_bytes)
    vec_hits, entry_hits = _k8_cover(m, row_bytes)
    assert vec_hits.shape == (m * row_bytes // 16,) and (vec_hits == 1).all()
    assert entry_hits.shape == (m,) and (entry_hits == 1).all()


# ----------------------------------------------------------------------- P1

B, H, W = 2, 16, 24


def _pad_h(x):
    return np.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))


def _call_body(kern, xp, k, co, out_dtype, a=None):
    """``kern`` of ``tools/pallas_conv_proto.py`` in a ``pallas_call`` shaped
    like the one its ``main_*`` builds, interpreted."""
    bsz, hp, w, c = xp.shape
    h = hp - 2
    in_specs = [pl.BlockSpec(memory_space=pltpu.ANY),
                pl.BlockSpec(k.shape, lambda b, i: (0,) * k.ndim)]
    args = [xp, k]
    if a is not None:
        in_specs.append(pl.BlockSpec((1, co), lambda b, i: (0, 0)))
        args.append(a)
    return pl.pallas_call(
        functools.partial(kern, w=w, c=c, co=co),
        grid=(bsz, h // proto.BH),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((1, proto.BH, w, co), lambda b, i: (b, i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bsz, h, w, co), out_dtype),
        scratch_shapes=[pltpu.VMEM((proto.BH + 2, w, c), xp.dtype), pltpu.SemaphoreType.DMA],
        interpret=True,
    )(*args)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("c,co", [(8, 16), (32, 8)])
def test_conv_probe_conv_matches_the_pallas_probes(c, co):
    rng = np.random.RandomState(c)
    xp = _pad_h(rng.randn(B, H, W, c).astype(np.float32))
    k = (rng.randn(3, 3, c, co) * 0.1).astype(np.float32)
    got = probes.conv_probe(torch.from_numpy(xp), torch.from_numpy(k), "conv").numpy()
    _close(got, proto.conv3x3_pallas(jnp.asarray(xp), jnp.asarray(k), interpret=True))
    k9 = np.transpose(k, (2, 0, 1, 3)).reshape(c, -1)  # the tool's pack_k
    _close(got, proto.conv3x3_shiftout(jnp.asarray(xp), jnp.asarray(k9), False, interpret=True))
    # the padding rows count: a probe input with data in them gives another answer
    xq = xp.copy()
    xq[:, 0] = 1.0
    assert not np.allclose(probes.conv_probe(torch.from_numpy(xq), torch.from_numpy(k),
                                             "conv").numpy()[:, 0], got[:, 0])


@pytest.mark.parametrize("c,co,kshape", [(8, 16, "33"), (32, 8, "9")])
def test_conv_probe_dots_matches_the_pallas_kernel_body(c, co, kshape):
    rng = np.random.RandomState(c + 1)
    xp = rng.randn(B, H + 2, W, c).astype(np.float32)  # dots reads the rows as they are
    k = (rng.randn(3, 3, c, co) * 0.1).astype(np.float32)
    if kshape == "9":
        k = k.reshape(9, c, co)
        want = _call_body(proto._kernel_n512, jnp.asarray(xp), jnp.asarray(k), co, jnp.float32)
    else:
        want = _call_body(proto._kernel_dots, jnp.asarray(xp), jnp.asarray(k), co, jnp.float32)
    got = probes.conv_probe(torch.from_numpy(xp), torch.from_numpy(k), "dots")
    _close(got.numpy(), want)


@pytest.mark.parametrize("kern,relu", [("_kernel_int8", True), ("_kernel_int8_n512", False)])
def test_conv_probe_int8_matches_the_pallas_kernel_body(kern, relu):
    c, co = 32, 16
    rng = np.random.RandomState(7)
    xp = rng.randint(-127, 128, (B, H + 2, W, c)).astype(np.int8)
    k = rng.randint(-127, 128, (9, c, co)).astype(np.int8)
    a = (np.abs(rng.randn(1, co)) * 2e-3).astype(np.float32)
    if relu:  # signs on both sides of the relu
        a[0, ::2] *= -1.0
    want = np.asarray(_call_body(getattr(proto, kern), jnp.asarray(xp), jnp.asarray(k), co,
                                 jnp.int8, jnp.asarray(a)))
    got = probes.conv_probe(torch.from_numpy(xp), torch.from_numpy(k), "int8",
                            torch.from_numpy(a), relu=relu).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 50 and (got == -127).mean() < 0.9  # the codes spread


def test_conv_probe_relu_defaults_to_the_two_tpu_probes():
    """Co 128 is the probe with a relu, any other width the one without."""
    rng = np.random.RandomState(9)
    xp = rng.randint(-127, 128, (1, 10, 8, 32)).astype(np.int8)
    for co in (128, 256):
        k = rng.randint(-127, 128, (9, 32, co)).astype(np.int8)
        a = torch.full((co,), -1e-3)
        args = (torch.from_numpy(xp), torch.from_numpy(k), "int8", a)
        assert torch.equal(probes.conv_probe(*args), probes.conv_probe(*args, relu=co == 128))


@pytest.mark.parametrize("bad", ["mode", "dtype", "taps", "scale"])
def test_conv_probe_rejects(bad):
    xp, k = torch.zeros(1, 10, 8, 16), torch.zeros(3, 3, 16, 8)
    with pytest.raises((ValueError, TypeError)):
        if bad == "mode":
            probes.conv_probe(xp, k, "im2col")
        elif bad == "dtype":
            probes.conv_probe(xp, k.to(torch.bfloat16), "conv")
        elif bad == "taps":
            probes.conv_probe(xp, k[:2], "conv")
        else:
            probes.conv_probe(xp.to(torch.int8), k.to(torch.int8), "int8")


# ----------------------------------------------------------------------- P2


def _mxu_formula(a, b, reps=8):
    """``kern`` of ``tools/mxu_rate.py``."""
    acc = jnp.zeros((a.shape[0], b.shape[1]), jnp.float32)
    for r in range(reps):
        acc += jnp.dot(a + jnp.float32(r).astype(a.dtype), b, preferred_element_type=jnp.float32)
    return acc.astype(a.dtype)


@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (128, 64, 96)])
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 1e-2), ("float32", 1e-5)])
def test_mma_rate_matches_the_mxu_formula(m, k, n, dtype, tol):
    rng = np.random.RandomState(m + n)
    a = (rng.randn(m, k) * 0.05).astype(np.float32)
    b = (rng.randn(k, n) * 0.05).astype(np.float32)
    want = _mxu_formula(jnp.asarray(a, dtype), jnp.asarray(b, dtype))
    tdt = getattr(torch, dtype)
    got = probes.mma_rate(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), tol)


def test_mma_rate_int8_is_exact():
    rng = np.random.RandomState(4)
    a = rng.randint(-127, 128, (64, 128)).astype(np.int8)  # a + r wraps where a > 120
    b = rng.randint(-127, 128, (128, 32)).astype(np.int8)
    want = sum((a + np.int8(r)).astype(np.int8).astype(np.int32) @ b.astype(np.int32)
               for r in range(8))
    got = probes.mma_rate(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        probes.mma_rate(torch.from_numpy(a), torch.from_numpy(b).float())


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_rotation_rule_equals_the_plain_add_on_every_value(dtype):
    """bfloat16 (one rounding to nearest even) and int8 (wrap-around): the
    kernels' rotation equals ``(a + r).to(a.dtype)`` of ``mma_rate_plain``
    and the add of ``tools/mxu_rate.py``'s ``kern`` on every finite value of
    the type, for each r < 8 (against ``kern`` but for bfloat16's subnormals,
    which XLA's CPU backend flushes to zero)."""
    ibits = torch.int16 if dtype == "bfloat16" else torch.int8
    if dtype == "int8":
        a = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
        normal = torch.ones_like(a, dtype=torch.bool)
    else:
        a = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
        a = a[torch.isfinite(a.float())]
        normal = (a == 0) | (a.float().abs() >= torch.finfo(torch.bfloat16).tiny)
    aj = jnp.asarray(a[normal].view(ibits).numpy()).view(jnp.dtype(dtype))
    for r in range(8):
        got = probes.rotate_plain(a, r)
        assert torch.equal(got.view(ibits), (a + r).to(a.dtype).view(ibits))
        want = np.asarray(aj + jnp.float32(r).astype(aj.dtype)).view(aj.dtype.name.replace(
            "bfloat16", "int16"))
        np.testing.assert_array_equal(got[normal].view(ibits).numpy(), want)


def test_rotation_rule_rounds_to_tf32():
    """float32: the float32 add, then cvt.rna to TF32: the low 13 bits
    cleared, the nearest TF32 value, a tie away from zero; within 2**-11 of
    ``mma_rate_plain``'s float32 add."""
    rng = np.random.RandomState(5)
    a = torch.from_numpy(np.concatenate([rng.randn(4096) * 0.05, rng.randn(4096) * 300]
                                        ).astype(np.float32))
    for r in range(8):
        exact = a + r
        got = probes.rotate_plain(a, r)
        assert not (got.view(torch.int32) & 0x1FFF).any()
        assert ((got - exact).abs() <= exact.abs() * 2.0 ** -11).all()
        # no TF32 value lies nearer: the neighbours one TF32 step away
        step = torch.ldexp(torch.ones_like(got), torch.frexp(got)[1] - 11)
        assert ((got - exact).abs() <= (got + step - exact).abs()).all()
        assert ((got - exact).abs() <= (got - step - exact).abs()).all()
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 3 + 2 ** -10], dtype=torch.float32)
    assert probes.rotate_plain(ties, 0).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 3 + 2 ** -9]


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 1e-2), ("int8", 0.0), ("float32", 1e-3)])
def test_products_of_the_rotated_a_match_plain_and_the_mxu_formula(dtype, tol):
    """The eight products the kernels compute, ``sum_r rotate_plain(a, r) @ b``
    with float32 sums (int8: exact), against ``mma_rate_plain`` (bfloat16,
    int8: equal; TF32: within 1e-3 x max|ref|, the TF32 rounding of A) and
    against ``kern`` of ``tools/mxu_rate.py`` (bfloat16 1e-2, as above)."""
    rng = np.random.RandomState(6)
    m, k, n = 64, 128, 32
    if dtype == "int8":
        a = rng.randint(-127, 128, (m, k)).astype(np.int8)
        b = rng.randint(-127, 128, (k, n)).astype(np.int8)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        got = sum(probes.rotate_plain(ta, r).to(torch.int64) @ tb.to(torch.int64)
                  for r in range(8)).to(torch.int32)
        # kern's add; its int8 products summed in int32 (kern's own cast
        # of the sum to int8 would wrap)
        want = sum(np.asarray(jnp.asarray(a) + jnp.float32(r).astype(jnp.int8)).astype(np.int32)
                   @ b.astype(np.int32) for r in range(8))
    else:
        a = (rng.randn(m, k) * 0.05).astype(np.float32)
        b = (rng.randn(k, n) * 0.05).astype(np.float32)
        tdt = getattr(torch, dtype)
        ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
        got = sum(probes.rotate_plain(ta, r).double() @ tb.double() for r in range(8)).to(tdt)
        want = _mxu_formula(jnp.asarray(a, dtype), jnp.asarray(b, dtype))
    plain = probes.mma_rate_plain(ta, tb)
    assert got.dtype == plain.dtype
    _close(got.double().numpy(), plain.double().numpy(), tol)
    _close(got.double().numpy(), np.asarray(want, np.float64), max(tol, 1e-5))


# ------------------------------------------------------- card-only (gpu)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


# (dtype, channels): rows of 96, 128, 32, 16, 64, 512 and 1024 bytes
K8_CARD_ROWS = [(torch.float32, 24), (torch.bfloat16, 64), (torch.int8, 32), (torch.float32, 4),
                (torch.bfloat16, 32), (torch.bfloat16, 256), (torch.int8, 1024)]


def _k8_on_card(tt, ti, n_win):
    """The wrapper (one launch) and the bare launch against the plain version:
    rows bit-equal, counts equal. Returns the count."""
    before = expand.gather_rows_windowed.launches
    got, n_over = expand.gather_rows_windowed(tt, ti, n_win)
    assert expand.gather_rows_windowed.launches == before + 1
    want, want_n = expand.gather_rows_windowed_plain(tt, ti, n_win)
    assert got.shape == want.shape and n_over.shape == () and n_over.dtype == torch.int32
    assert torch.equal(got, want) and int(n_over) == int(want_n)
    bare = torch.full_like(want, 7)
    n_bare = torch.full((), -1, dtype=torch.int32, device=tt.device)
    expand.launch_gather_win(tt, ti, n_win, bare, n_bare)
    assert torch.equal(bare, want) and int(n_bare) == int(want_n)
    return int(n_over)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", K8_CARD_ROWS)
@pytest.mark.parametrize("n_win,widen", [(2, 0), (3, 2), (1, 2)])
def test_gather_rows_windowed_kernel_matches_plain_on_card(cuda, dtype, c, n_win, widen):
    table, idx = _windowed_case(n_win, 4096, seed=n_win, c=c, widen=widen)
    tt, ti = torch.from_numpy(table * 20).to(cuda, dtype), torch.from_numpy(idx).to(cuda)
    n_over = _k8_on_card(tt, ti, n_win)
    assert (n_over > 0) == (widen > 0)


def _k8_card_case(cuda, dtype, c, r, idx, seed=0):
    rng = np.random.RandomState(seed)
    tt = torch.from_numpy(rng.randn(r, c).astype(np.float32) * 20).to(cuda, dtype)
    return tt, torch.from_numpy(np.asarray(idx, np.int32)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 32), (torch.bfloat16, 256)])
def test_gather_rows_windowed_kernel_with_more_ctas_than_the_card_holds(cuda, dtype, c):
    """1200 blocks of 512 entries: 2400 CTAs at 64-byte rows, 19200 at
    512-byte rows, above the 132 SMs x 8 CTAs the card holds at once (64
    registers a thread); every third block with a too-small window."""
    rng = np.random.RandomState(4)
    r, blocks = 60000, 1200
    start = rng.randint(0, r - 2 * BLK, size=blocks)
    idx = start[:, None] + np.sort(rng.randint(0, 2 * BLK, size=(blocks, BLK)), axis=1)
    idx[::3, -1] = r - 1
    tt, ti = _k8_card_case(cuda, dtype, c, r, idx.ravel())
    assert _k8_on_card(tt, ti, 3) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 64), (torch.bfloat16, 256)])
def test_gather_rows_windowed_kernel_edge_cases(cuda, dtype, c):
    """No entries; a block of sentinels only; a window start clipped at the
    table's end; a window over the whole table; the window one block too
    small."""
    r = 3000
    tt, ti = _k8_card_case(cuda, dtype, c, r, np.zeros(0))
    got, n_over = expand.gather_rows_windowed(tt, ti, 2)
    assert got.shape == (0, c) and int(n_over) == 0
    _k8_on_card(tt, ti, 2)
    rng = np.random.RandomState(5)
    sentinel = np.full(BLK, PAD)
    sentinel[::7] = -1
    sentinel[1::7] = r + 5  # beyond the table: not active, zero rows
    tail = np.sort(rng.randint(r - 400, r, size=BLK))  # start clipped to r_full/512 - n_win
    spread = np.sort(rng.randint(0, r, size=BLK))
    idx = np.concatenate([sentinel, tail, spread])
    tt, ti = _k8_card_case(cuda, dtype, c, r, idx, seed=6)
    n_full = -(-r // BLK) + 1  # covers the padded table
    assert _k8_on_card(tt, ti, n_full) == 0
    # only the spread block overflows: the clipped block's window holds its rows
    assert _k8_on_card(tt, ti, 2) == int(expand.window_overflow(ti[2 * BLK:], r, 2)) > 0
    least = next(n for n in range(1, n_full + 1) if int(expand.window_overflow(ti, r, n)) == 0)
    assert _k8_on_card(tt, ti, least) == 0 < _k8_on_card(tt, ti, least - 1)


@pytest.mark.gpu
def test_gather_rows_windowed_count_after_an_overflowing_call_is_its_own(cuda):
    """The count's scratch lives across calls: two calls in a row give the
    same count, a call after an overflowing one counts 0, on two streams
    too."""
    table, idx = _windowed_case(1, 4096, seed=12, c=64, widen=2)
    tt, ti = torch.from_numpy(table).to(cuda, torch.bfloat16), torch.from_numpy(idx).to(cuda)
    ok_table, ok_idx = _windowed_case(3, 4096, seed=3, c=64)
    ok_t, ok_i = torch.from_numpy(ok_table).to(cuda, torch.bfloat16), torch.from_numpy(ok_idx).to(
        cuda)
    want = int(expand.window_overflow(ti, 4096, 1))
    assert want > 0
    counts = [expand.gather_rows_windowed(tt, ti, 1)[1] for _ in range(2)]
    after = expand.gather_rows_windowed(ok_t, ok_i, 3)[1]
    assert [int(n) for n in counts] == [want, want] and int(after) == 0
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        on_side = expand.gather_rows_windowed(tt, ti, 1)[1]
    main = expand.gather_rows_windowed(ok_t, ok_i, 3)[1]
    torch.cuda.synchronize()
    assert int(on_side) == want and int(main) == 0
    with torch.cuda.stream(side):
        assert int(expand.gather_rows_windowed(ok_t, ok_i, 3)[1]) == 0


@pytest.mark.gpu
def test_gather_rows_windowed_refuses_graph_capture(cuda):
    """The count's scratch word is kept per stream, and a captured graph would
    replay one word on any stream: the wrapper and the bare launch raise under
    capture, and the calls after it still count their own."""
    table, idx = _windowed_case(1, 4096, seed=12, c=64, widen=2)
    tt, ti = torch.from_numpy(table).to(cuda, torch.bfloat16), torch.from_numpy(idx).to(cuda)
    want = int(expand.window_overflow(ti, 4096, 1))
    assert int(expand.gather_rows_windowed(tt, ti, 1)[1]) == want > 0
    out, over = torch.empty(ti.numel(), 64, dtype=tt.dtype, device=cuda), ti.new_empty(())
    for call in (lambda: expand.gather_rows_windowed(tt, ti, 1),
                 lambda: expand.launch_gather_win(tt, ti, 1, out, over)):
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="CUDA graph"):
            with torch.cuda.graph(graph):
                call()
    assert _k8_on_card(tt, ti, 1) == want


@pytest.mark.gpu
@pytest.mark.parametrize("mode,route,c,co", [
    ("conv", "mma_sync", 64, 128), ("dots", "mma_sync", 64, 128), ("int8", "mma_sync", 64, 128),
    ("conv", "wgmma", 64, 128), ("dots", "wgmma", 64, 128), ("conv", "wgmma", 128, 256),
    ("int8", "wgmma", 128, 128)])
def test_conv_probe_kernel_matches_plain_on_card(cuda, mode, route, c, co):
    gen = torch.Generator().manual_seed(1)
    if mode == "int8":
        xp = torch.randint(-127, 128, (2, 21, 37, c), generator=gen, dtype=torch.int8).to(cuda)
        k = torch.randint(-127, 128, (3, 3, c, co), generator=gen, dtype=torch.int8).to(cuda)
        args = (xp, k, mode, (torch.randn(co, generator=gen) * 2e-4).to(cuda))
    else:
        xp = torch.randn(2, 21, 37, c, generator=gen).to(cuda, torch.bfloat16)
        args = (xp, (torch.randn(3, 3, c, co, generator=gen) * 0.05).to(cuda, torch.bfloat16), mode)
    before = probes.conv_probe.launches
    got, want = probes.conv_probe(*args, route=route), probes.conv_probe_plain(*args)
    assert probes.conv_probe.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (0.0 if mode == "int8" else 1e-2 * want.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("route", probes.ROUTES)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.int8, 0.0),
                                       (torch.float32, 1e-3)], ids=["bf16", "int8", "tf32"])
@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (128, 512, 256), (192, 256, 192)])
def test_mma_rate_kernel_matches_plain_on_card(cuda, route, dtype, tol, m, k, n):
    gen = torch.Generator().manual_seed(m + n)
    if dtype == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).to(cuda)
        b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8).to(cuda)
    else:
        a = (torch.randn(m, k, generator=gen) * 0.05).to(cuda, dtype)
        b = (torch.randn(k, n, generator=gen) * 0.05).to(cuda, dtype)
    before = probes.mma_rate.launches
    got = probes.mma_rate(a, b, route=route, grid_reps=2)
    assert probes.mma_rate.launches == before + 1
    want = probes.mma_rate_plain(a, b)
    err = (got.double() - want.double()).abs().max().item()
    assert got.dtype == want.dtype and err <= tol * want.double().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("grid_reps", [1, 3])
@pytest.mark.parametrize("shape,dtype", [*probe_bench.MMA_CASES, ((8192, 256, 768), torch.bfloat16),
                                         ((8192, 256, 768), torch.int8)],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple)
                         else probe_bench.type_name(v))
def test_mma_rate_wgmma_route_matches_plain_at_every_case_on_card(cuda, shape, dtype, grid_reps):
    """P2's ``wgmma`` route (persistent CTAs over tiles of 128 rows x BN, A in
    registers) at the 15 ``MMA_CASES`` of the rate table and at (8192, 256,
    768), 64 x 3 tiles of BN 256: more than an H100's 132 CTAs, so a CTA
    walks several tiles; bfloat16 within 1e-2, TF32 within 1e-3 x max|ref|,
    int8 equal; every grid repeat writes the same values."""
    a, b = probe_bench._rate_operands(shape, dtype, cuda, torch.Generator().manual_seed(23))
    before = probes.mma_rate.launches
    got = probes.mma_rate(a, b, route="wgmma", grid_reps=grid_reps)
    assert probes.mma_rate.launches == before + 1
    want = probes.mma_rate_plain(a, b)
    torch.cuda.synchronize()
    tol = probe_bench.TOL[probe_bench.type_name(dtype)]
    err = (got.double() - want.double()).abs().max().item()
    assert got.dtype == want.dtype and err <= tol * want.double().abs().max().item()


# (mode, B, H, W, C, Co) on the wgmma route: ragged H and W (tiles are 4 x 64
# pixels), C 64-256 (int8: 128, 256), Co 128 and 512, B 1 and 2
WGMMA_CASES = [("conv", 1, 19, 37, 64, 128), ("conv", 2, 13, 130, 128, 512),
               ("conv", 2, 6, 64, 256, 128), ("dots", 1, 7, 90, 64, 512),
               ("dots", 2, 21, 70, 256, 128), ("int8", 1, 19, 37, 128, 128),
               ("int8", 2, 5, 130, 256, 512), ("int8", 2, 22, 66, 128, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,b,h,w,c,co", WGMMA_CASES)
def test_conv_probe_wgmma_route_matches_plain_on_card(cuda, mode, b, h, w, c, co):
    """bfloat16 within 1e-2 x max|ref|; int8 every code equal, with and
    without the relu."""
    gen = torch.Generator().manual_seed(b * h + w + c)
    if mode == "int8":
        xp = torch.randint(-127, 128, (b, h + 2, w, c), generator=gen, dtype=torch.int8).to(cuda)
        k = torch.randint(-127, 128, (3, 3, c, co), generator=gen, dtype=torch.int8).to(cuda)
        a = (torch.randn(co, generator=gen) * 2e-4 * 128 / c).to(cuda)
        cases = [(xp, k, mode, a, relu) for relu in (True, False)]
    else:
        xp = torch.randn(b, h + 2, w, c, generator=gen).to(cuda, torch.bfloat16)
        k = (torch.randn(3, 3, c, co, generator=gen) * 0.05).to(cuda, torch.bfloat16)
        cases = [(xp, k, mode)]
    for args in cases:
        before = probes.conv_probe.launches
        got, want = probes.conv_probe(*args, route="wgmma"), probes.conv_probe_plain(*args)
        assert probes.conv_probe.launches == before + 1
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        if mode == "int8":
            assert torch.equal(got, want)
            assert len(torch.unique(got)) > 50  # the codes spread
        else:
            err = (got.float() - want.float()).abs().max().item()
            assert err <= 1e-2 * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("mode,c,co", [("conv", 32, 128), ("dots", 64, 64), ("int8", 64, 128)])
def test_conv_probe_wgmma_route_rejects_other_widths_on_card(cuda, mode, c, co):
    dtype = torch.int8 if mode == "int8" else torch.bfloat16
    xp = torch.zeros(1, 6, 8, c, device=cuda, dtype=dtype)
    k = torch.zeros(3, 3, c, co, device=cuda, dtype=dtype)
    a = torch.ones(co, device=cuda) if mode == "int8" else None
    with pytest.raises(ValueError, match="wgmma route"):
        probes.conv_probe(xp, k, mode, a, route="wgmma")
