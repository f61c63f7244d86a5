"""The two accuracy gates of the port on the CPU, at a tiny grid:
``tools/torch_quality_gate.py`` (phase A trains the space-to-depth teacher
beside the student, phase B distils twice from that state, the float32 and
the ``INT8: static`` teacher) and ``tools/torch_overfit_check.py``. One step
a phase is no convergence: these tests hold the tools' wiring and output
lines, what ``chip_smoke.py`` runs at grid 256 on the card holds the gates.
And the ``DCN_R`` clamp that the gate's ``dcn_r8`` variant sets.
"""

import pytest
import torch

from tools import torch_overfit_check, torch_quality_gate

torch.set_num_threads(1)


def test_quality_gate_runs_both_legs_and_prints_its_result(capsys):
    res = torch_quality_gate.main(["--variant", "int8", "--scenes", "2", "--steps_a", "1",
                                   "--steps_b", "1", "--grid", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "RESULT variant=int8 over 2 scenes (variant - base):" in out
    assert "  distill-loss delta: " in out and "  scene-mAP   delta: " in out
    assert "  gate: " in out and out.count("[B variant] 1 steps") == 2
    assert len(res["d_loss"]) == len(res["d_ap"]) == 2 and isinstance(res["ship"], bool)
    # the int8 leg's teacher is another function than the float leg's
    assert all(d != 0.0 for d in res["d_loss"])


def test_overfit_check_trains_and_judges_one_scene(capsys):
    # one step does not halve the loss: the check must say so
    with pytest.raises(AssertionError, match="loss did not drop"):
        torch_overfit_check.main(["1", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 0: loss " in out and "final mAP on the overfit scene: " in out


def test_dcn_r_sets_the_clamp_of_the_kernel_path(monkeypatch):
    """``--variant dcn_r8`` sets ``DCN_R``: where the reference's gate holds,
    the offsets are clamped to +-DCN_R cells (5 when unset), read at each call."""
    from radardistill_tpu_torch.ops import dcn

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 40, 40, 128, generator=gen)
    off = torch.randn(1, 20, 20, 18, generator=gen) * 8.0
    mask = torch.rand(1, 20, 20, 9, generator=gen)
    w = torch.randn(3, 3, 128, 16, generator=gen) * 0.05
    assert dcn.shapes_supported(x.shape, off.shape, 2, 1, 3)

    def clamped(r):
        return dcn._ModulatedDeformConv.apply(x, off, mask, w, 2, 1, 3, r)

    monkeypatch.delenv("DCN_R", raising=False)
    assert dcn.dcn_max_offset() == dcn.DCN_MAX_OFFSET == 5
    assert torch.equal(dcn.modulated_deform_conv(x, off, mask, w, 2, 1, 3), clamped(5))
    monkeypatch.setenv("DCN_R", "8")
    y8 = dcn.modulated_deform_conv(x, off, mask, w, 2, 1, 3)
    assert torch.equal(y8, clamped(8)) and not torch.equal(y8, clamped(5))
