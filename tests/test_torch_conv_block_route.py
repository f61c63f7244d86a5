"""K1's routes on the card, checked here on the CPU through what surrounds the
kernels: the dispatch rule of ``ops.conv_block.conv_block``, the K-major
weight the ``wgmma`` route reads, and the border algebra that lets that
route read zeros outside the image where the link pads with ``zpad``.

The border check is exact integer arithmetic on both sides (``int_conv_exact``
is exact, the correction is an int32 sum), so it is held bit for bit.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from radardistill_tpu_torch.ops import conv3x3_wgmma
from radardistill_tpu_torch.ops import conv_block as cb


@pytest.mark.parametrize("kh", [2, 3])
@pytest.mark.parametrize("zpad", [0, -127])
def test_border_correction_turns_zero_padding_into_zpad(kh, zpad):
    """int_conv_exact(x, k, pad 0) + border_correction == int_conv_exact(x, k,
    pad zpad) on an odd 7 x 13 grid, for both windows (3x3 padded (1, 1),
    2x2 padded (1, 0))."""
    rng = np.random.RandomState(10 + kh)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 7, 13, 8)).astype(np.int8))
    kq = torch.from_numpy(rng.randint(-127, 128, (kh, kh, 8, 5)).astype(np.int8))
    pad = (1, 1) if kh == 3 else (1, 0)
    zero_padded = cb.int_conv_exact(xq, kq, 1, (pad, pad), 0)
    want = cb.int_conv_exact(xq, kq, 1, (pad, pad), zpad)
    corr = cb.border_correction(cb.tap_sums(kq), 7, 13, kh, zpad)
    assert corr.dtype == torch.int32 and tuple(corr.shape) == (7, 13, 5)
    assert torch.equal(zero_padded + corr, want)
    # the correction lives on the padded rows and columns only
    inner = corr[1:-1, 1:-1] if kh == 3 else corr[1:, 1:]
    assert not inner.any()
    assert bool(corr[0].any()) == (zpad != 0)


def test_tap_sums_sum_to_the_link_constants_ksum():
    kq = torch.from_numpy(np.random.RandomState(12).randint(-127, 128, (3, 3, 16, 6))
                          .astype(np.int8))
    wsum = cb.tap_sums(kq)
    assert wsum.dtype == torch.int32 and tuple(wsum.shape) == (9, 6)
    assert torch.equal(wsum.sum(dim=0).float(), kq.float().sum(dim=(0, 1, 2)))


@pytest.mark.parametrize("kh", [2, 3])
def test_wgmma_taps_are_k_major(kh):
    """wk[t, co, c] == kq[t // kh, t % kh, c, co], by an explicit index loop."""
    kq = torch.from_numpy(np.random.RandomState(13).randint(-127, 128, (kh, kh, 8, 5))
                          .astype(np.int8))
    wk = conv3x3_wgmma.wgmma_taps(kq)
    assert tuple(wk.shape) == (kh * kh, 5, 8) and wk.is_contiguous() and wk.dtype == torch.int8
    assert torch.equal(conv3x3_wgmma.wgmma_taps(kq.reshape(kh * kh, 8, 5)), wk)
    for t in range(kh * kh):
        for co in range(5):
            for c in range(8):
                assert wk[t, co, c] == kq[t // kh, t % kh, c, co]


def test_dispatch_of_the_int8_stages_5_chain():
    """All 23 links of ``INT8_STAGES: 5`` go to ``wgmma``: the four stage-1
    links, the 14 deeper links with C and Co multiples of 128, and the five
    Co-64 links (the transposed kernel); a float32 output never takes
    ``wgmma``."""
    stage1 = [((720, 128, 128, 3), 4)]
    deep = [((hw, c, co, kh), n_plain + n_res)
            for hw, c, co, kh, n_plain, n_res in chip_smoke.INT8_DEEP_LINKS]
    count = {"wgmma": 0, "resident": 0, "streamed": 0}
    for (_, c, co, kh), n in stage1 + deep:
        for nph in (1, 4):
            route = cb.route_of(kh, c, co, nph, torch.int8)
            assert route == cb.route_of(kh, c, co, nph, torch.bfloat16)
            assert route == "wgmma", (c, co, kh, nph)
            assert cb.route_of(kh, c, co, nph, torch.float32) != "wgmma"
        count[cb.route_of(kh, c, co, 1, torch.int8)] += n
    assert sum(n for _, n in deep) == 19
    assert count == {"wgmma": 23, "resident": 0, "streamed": 0}
    # the deeper weights beyond shared memory, in float32, stream
    assert cb.route_of(3, 256, 256, 1, torch.float32) == "streamed"
    assert cb.route_of(2, 512, 256, 1, torch.float32) == "streamed"
    # three mask phases, or C 64 into Co 128: mma.sync
    assert cb.route_of(3, 128, 384, 3, torch.int8) != "wgmma"
    assert cb.route_of(3, 64, 128, 1, torch.int8) == "resident"


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("nph", [1, 2, 4])
@pytest.mark.parametrize("c", [64, 128])
def test_co64_links_take_the_transposed_wgmma_kernel(c, nph, out_dtype):
    """Co 64 with C a multiple of 64 (one or two 64-channel chunks), 1, 2 or 4
    mask phases and an int8 or bfloat16 output: ``wgmma``, both windows."""
    assert cb.wgmma_takes(c, 64, nph, out_dtype)
    for kh in (2, 3):
        assert cb.route_of(kh, c, 64, nph, out_dtype) == "wgmma"


@pytest.mark.parametrize("c,co,nph,out_dtype,route", [
    (96, 64, 1, torch.int8, "resident"),        # C not a multiple of 64
    (64, 32, 1, torch.int8, "resident"),        # Co 32: no tile of the kernel
    (64, 128, 1, torch.int8, "resident"),       # C 64 into Co 128: half a mainloop chunk
    (64, 64, 1, torch.float32, "resident"),     # a float32 output
    (64, 64, 3, torch.int8, "streamed"),        # three mask phases
], ids=["c96", "co32", "c64-co128", "f32-out", "nph3"])
def test_shapes_the_transposed_kernel_does_not_take(c, co, nph, out_dtype, route):
    assert not cb.wgmma_takes(c, co, nph, out_dtype)
    assert cb.route_of(3, c, co, nph, out_dtype) == route


@pytest.mark.parametrize("kh,c", [(3, 64), (2, 128)], ids=["kh3-c64", "kh2-c128"])
def test_co64_wgmma_taps_give_the_plain_conv(kh, c):
    """The K-major taps (kh * kh, 64, C) the transposed kernel reads as its A
    operand, summed as it sums them (tap t = ky * kh + kx reads the input cell
    (y + ky - 1, x + kx - 1), zero outside), give the exact integer
    convolution, and with the border correction the one padded with zpad:
    the two Co-64 link shapes of ``INT8_STAGES: 5``."""
    rng = np.random.RandomState(20 + kh)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 7, 13, c)).astype(np.int8))
    kq = torch.from_numpy(rng.randint(-127, 128, (kh, kh, c, 64)).astype(np.int8))
    wk = conv3x3_wgmma.wgmma_taps(kq)
    assert tuple(wk.shape) == (kh * kh, 64, c) and wk.is_contiguous() and wk.dtype == torch.int8
    xp = torch.nn.functional.pad(xq.long(), (0, 0, 1, 1, 1, 1))  # 2x2 reads rows -1, 0
    acc = torch.zeros(2, 7, 13, 64, dtype=torch.long)
    for t in range(kh * kh):
        ky, kx = divmod(t, kh)
        acc += xp[:, ky:ky + 7, kx:kx + 13] @ wk[t].long().t()
    pad = (1, 1) if kh == 3 else (1, 0)
    assert torch.equal(acc.int(), cb.int_conv_exact(xq, kq, 1, (pad, pad), 0))
    corr = cb.border_correction(cb.tap_sums(kq), 7, 13, kh, -127)
    assert torch.equal(acc.int() + corr, cb.int_conv_exact(xq, kq, 1, (pad, pad), -127))


def _border_table(wsum, kh, zpad):
    """The transposed kernel's border table (``conv_co64_kernel``): entry (f,
    co) is zpad x the weight sums of the taps outside the image for the class
    f of a pixel, flags 1: row 0, 2: row H - 1, 4: column 0, 8: column W - 1
    (tap (ky, kx) reads row y + ky - 1, column x + kx - 1)."""
    table = torch.zeros(16, wsum.shape[1], dtype=torch.int32)
    for f in range(16):
        for ky in range(kh):
            for kx in range(kh):
                if ((f & 1 and ky == 0) or (f & 2 and ky == 2) or (f & 4 and kx == 0)
                        or (f & 8 and kx == 2)):
                    table[f] += wsum[ky * kh + kx]
    return zpad * table


@pytest.mark.parametrize("kh", [2, 3])
@pytest.mark.parametrize("h,w", [(7, 13), (1, 1), (1, 2), (2, 129)])
def test_border_table_classes_give_the_border_correction(kh, h, w):
    """The kernel's rule on the CPU: a pixel's class (its row 0 / H - 1 and
    column 0 / W - 1 flags, both flags of a side on a 1-wide image) picks the
    table entry that equals ``border_correction`` at that pixel."""
    kq = torch.from_numpy(np.random.RandomState(30 + kh).randint(-127, 128, (kh, kh, 16, 64))
                          .astype(np.int8))
    wsum = cb.tap_sums(kq)
    table = _border_table(wsum, kh, -127)
    want = cb.border_correction(wsum, h, w, kh, -127)
    for y in range(h):
        for x in range(w):
            f = (y == 0) | (y == h - 1) << 1 | (x == 0) << 2 | (x == w - 1) << 3
            assert torch.equal(table[f], want[y, x]), (y, x)


def test_cpu_tensors_take_the_plain_version_on_any_route():
    rng = np.random.RandomState(14)
    xq = torch.from_numpy(rng.randint(-127, 128, (1, 5, 6, 128)).astype(np.int8))
    kq = torch.from_numpy(rng.randint(-127, 128, (3, 3, 128, 128)).astype(np.int8))
    ab = torch.from_numpy(rng.rand(8, 128).astype(np.float32) * 1e-4)
    mask = torch.ones((1, 5, 6, 1), dtype=torch.int8)
    before = (cb.conv_block.launches, dict(cb.conv_block.route_launches))
    got = cb.conv_block(xq, kq, ab, mask, zpad=-127, variant="wgmma")
    assert torch.equal(got, cb.conv_block_plain(xq, kq, ab, mask, zpad=-127))
    assert (cb.conv_block.launches, cb.conv_block.route_launches) == before


# ------------------------------------------------------------------ K6


def test_fp_dispatch_of_the_fp_stages_5_chain():
    """All 19 links of ``FP_STAGES: 5`` go to K6's ``wgmma`` route in
    bfloat16 (the four 720² Co-64 links on its 64-channel tile); float32
    takes the FFMA kernel; C % 64 != 0, or Co neither 64 nor a multiple of
    128, stays on ``mma.sync``."""
    count = dict.fromkeys(cb.FP_ROUTES, 0)
    for hw, c, co, kh, n_plain, n_res in chip_smoke.FP_LINKS:
        assert cb.fp_route_of(c, co, 1, torch.bfloat16) == "wgmma", (hw, c, co, kh)
        assert cb.fp_route_of(c, co, 1, torch.float32) == "ffma"
        count[cb.fp_route_of(c, co, 1, torch.bfloat16)] += n_plain + n_res
    assert count == {"wgmma": 19, "mma_sync": 0, "ffma": 0}
    for c, co in ((32, 64), (96, 128), (64, 32), (64, 192), (128, 16), (16, 96)):
        assert cb.fp_route_of(c, co, 1, torch.bfloat16) == "mma_sync", (c, co)
    # mask phases: 1, 2 or 4 of a multiple of 8 channels; the bare conv
    assert cb.fp_route_of(64, 64, 4, torch.bfloat16) == "wgmma"
    assert cb.fp_route_of(128, 128, 3, torch.bfloat16) == "mma_sync"
    assert cb.fp_route_of(64, 64, 8, torch.bfloat16) == "mma_sync"
    assert cb.fp_route_of(256, 256, 1, torch.bfloat16, identity=True) == "mma_sync"
    assert cb.fp_route_of(256, 256, 1, torch.float32, identity=True) == "ffma"


def _fp_operands(rng, b, h, w, c, co, kh, nph, res):
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
    k = torch.from_numpy(rng.randn(kh, kh, c, co).astype(np.float32) / (kh * kh * c) ** 0.5)
    ab = torch.from_numpy(np.stack([rng.rand(co) + 0.5, rng.randn(co) * 0.1]).astype(np.float32))
    mask = torch.from_numpy((rng.rand(b, h, w, nph) > 0.3).astype(np.int8))
    r = torch.from_numpy(rng.randn(b, h, w, co).astype(np.float32)) if res else None
    return x, k, ab, mask, r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", list(cb.FP_ROUTES) + [None])
def test_fp_cpu_tensors_take_the_plain_version_on_any_route(dtype, variant):
    """A CPU tensor takes ``conv_block_fp_plain`` whatever route is forced,
    and counts nothing."""
    x, k, ab, mask, r = _fp_operands(np.random.RandomState(15), 1, 5, 6, 64, 64, 3, 2, True)
    x, k, r = x.to(dtype), k.to(dtype), r.to(dtype)
    before = (cb.conv_block_fp.launches, dict(cb.conv_block_fp.route_launches))
    got = cb.conv_block_fp(x, k, ab, mask, r, variant=variant)
    assert torch.equal(got, cb.conv_block_fp_plain(x, k, ab, mask, r))
    assert (cb.conv_block_fp.launches, cb.conv_block_fp.route_launches) == before


@pytest.mark.parametrize("kh", [2, 3])
def test_fp_wgmma_taps_give_the_plain_conv(kh):
    """The K-major taps K6's ``wgmma`` route reads, (kh * kh, Co, C), summed
    as the kernel sums them (tap t = ky * kh + kx reads the input cell (y +
    ky - 1, x + kx - 1), zero outside), equal the plain version's bare
    convolution: 3x3 padded (1, 1), 2x2 padded (1, 0)."""
    rng = np.random.RandomState(16 + kh)
    x, k, _, _, _ = _fp_operands(rng, 2, 7, 13, 64, 64, kh, 1, False)
    wk = conv3x3_wgmma.wgmma_taps(k)
    assert tuple(wk.shape) == (kh * kh, 64, 64) and wk.is_contiguous()
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))  # zeros around; 2x2 reads rows -1, 0
    acc = torch.zeros(2, 7, 13, 64, dtype=torch.float64)
    for t in range(kh * kh):
        ky, kx = divmod(t, kh)
        acc += xp[:, ky:ky + 7, kx:kx + 13].double() @ wk[t].double().t()
    want = cb.conv_block_fp_plain(x, k, identity=True)
    assert (acc.float() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
