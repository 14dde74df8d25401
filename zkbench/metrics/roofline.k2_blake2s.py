"""Kernel K2's share of its roofline: the least time the window's jobs
need for the Blake2s compressions of their trace, interaction and
composition trees (``harness/roofline.py``), in per cent of the
window's device time of ``blake2s_messages``, ``blake2s_parents`` and
``blake2s_leaves_stream`` (FRI's trees run in that time too but are not
counted, so the share reads low)."""

from harness.roofline import k2_work

UNIT, LAYER, SOURCE, MOVES = "%", "kernels", "device_trace", "steps_per_s"
KERNELS = ("blake2s_messages", "blake2s_parents", "blake2s_leaves_stream")


def read(ctx):
    spent = ctx.kernel_seconds(KERNELS)
    if not spent or not ctx.jobs:
        return None
    need = sum(k2_work(ctx.shapes(j), ctx.blowup) for j in ctx.jobs)
    return 100.0 * need / spent
