"""Kernel K1's share of its roofline: the least time the window's jobs
need for their circle FFTs (``harness/roofline.py``: each committed
column interpolated and evaluated once, the composition's LDE and
combine), in per cent of the window's device time of K1 (``cfft_pass``,
every ``circle_fft`` and ``circle_ifft`` launch)."""

from harness.roofline import k1_work

UNIT, LAYER, SOURCE, MOVES = "%", "kernels", "device_trace", "steps_per_s"
KERNELS = ("cfft_pass",)


def read(ctx):
    spent = ctx.kernel_seconds(KERNELS)
    if not spent or not ctx.jobs:
        return None
    need = sum(k1_work(ctx.shapes(j), ctx.blowup) for j in ctx.jobs)
    return 100.0 * need / spent
