"""The train step's share of the card's peak: the work the step's mathematics
needs on the cell's inputs (counted by the frozen rules on the reference's
first step: convolutions, products and the float kernels at the bf16 tensor
peak, the int8 kernels' operations at the int8 peak), over the untraced
window's time per sample."""

from benchmark.lib.trace import PEAK_BF16, PEAK_INT8


def read(view):
    work, sec = view.cell.get("work"), view.cell.get("sec_per_unit")
    if not work or not sec:
        return None
    at_peak = work["float_flops"] / PEAK_BF16 + work["int8_ops"] / PEAK_INT8
    return 100.0 * at_peak / sec
