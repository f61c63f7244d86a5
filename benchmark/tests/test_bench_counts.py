"""The frozen count formulas (the reference's copies of the program's
``*_work`` functions, which the mfu and roofline readers divide) give the
kernel bounds that ``tests/test_torch_cost.py`` holds the program's own
formulas to, at the same shapes: K5, K2, K3, K4, K1, K6, K7."""

import pytest
import torch

from benchmark.lib.trace import PEAK_BF16, PEAK_BYTES, PEAK_INT8
from benchmark.reference.rdt.ops.conv_block import conv_block_fp_work, conv_block_work
from benchmark.reference.rdt.ops.dcn_grad import dcn_input_grad_work, dcn_offset_grad_work
from benchmark.reference.rdt.ops.dcn_sample import dcn_sample_work
from benchmark.reference.rdt.ops.expand import expand_rows_work
from benchmark.reference.rdt.ops.int8_conv import chain_conv_work

F32, BF, I8 = torch.float32, torch.bfloat16, torch.int8


def _meta(*shape, dtype=I8):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cma_sites():
    return [(_meta(2, h, h, 256, dtype=BF), _meta(2, ho, ho, 18, dtype=F32),
             _meta(2, ho, ho, 9, dtype=F32), _meta(2, ho, ho, 9 * 256, dtype=BF), h)
            for h, ho in ((180, 90), (90, 45), (180, 90))]


FP_LINKS = ((720, 64, 64, 3, 2, 2), (360, 256, 128, 2, 1, 0), (360, 128, 128, 3, 2, 2),
            (180, 512, 256, 2, 1, 0), (180, 256, 256, 3, 2, 2), (90, 1024, 256, 2, 1, 0),
            (90, 256, 256, 3, 2, 2))


def _k6():
    rows = []
    for hw, c, co, kh, n_plain, n_res in FP_LINKS:
        for res, n in ((None, n_plain), (_meta(2, hw, hw, co, dtype=BF), n_res)):
            rows += [conv_block_fp_work(_meta(2, hw, hw, c, dtype=BF), _meta(kh, kh, c, co, dtype=BF),
                                        _meta(2, co, dtype=F32), _meta(2, hw, hw, 1), res)] * n
    return rows


ROWS = {
    "K5": (lambda: [expand_rows_work(_meta(2 * 8193, 256, dtype=BF), _meta(2 * 180 ** 2, dtype=torch.int32)),
                    expand_rows_work(_meta(2 * 163841, 32), _meta(2 * 1440 ** 2, dtype=torch.int32))],
           PEAK_BF16, "0.0602 (bytes)"),
    "K2": (lambda: [dcn_sample_work(x, o, m, 2, 1, 3, 5.0) for x, o, m, _, _ in _cma_sites()],
           PEAK_BF16, "0.0736 (bytes)"),
    "K3": (lambda: [dcn_offset_grad_work(x, o, ds, m, 2, 1, 3, 5.0) for x, o, m, ds, _ in _cma_sites()],
           PEAK_BF16, "0.0748 (bytes)"),
    "K4": (lambda: [dcn_input_grad_work(ds, o, m, h, h, 2, 1, 3, 5.0) for _, o, m, ds, h in _cma_sites()],
           PEAK_BF16, "0.0736 (bytes)"),
    "K1": (lambda: [conv_block_work(_meta(2, 720, 720, 128), _meta(3, 3, 128, 128),
                                    _meta(8, 128, dtype=F32), _meta(2, 720, 720, 4), res)
                    for res in (None, None, _meta(2, 720, 720, 128), _meta(2, 720, 720, 128))],
           PEAK_INT8, "0.6201 (operations)"),
    "K6": (_k6, PEAK_BF16, "1.1736 (operations)"),
    "K7": (lambda: [chain_conv_work(_meta(2, 91, 90, 1024), _meta(2, 2, 1024, 256),
                                    _meta(8, 256, dtype=F32), _meta(2, 90, 90, 256))],
           PEAK_INT8, "0.0170 (operations)"),
}


@pytest.mark.parametrize("kid", sorted(ROWS))
def test_frozen_formula_gives_the_program_tests_bound(kid):
    rows, peak, printed = ROWS[kid]
    ops, nbytes = (sum(v) for v in zip(*rows()))
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = f"{max(ops_ms, bytes_ms):.4f} ({'bytes' if bytes_ms >= ops_ms else 'operations'})"
    assert bound == printed, (kid, ops_ms, bytes_ms)
