"""Share of its roofline that the `epoch_step` kernels reach in the traced
window: the calls' counted least time of the kernel's work (`work/epoch.py`
at the calls' shapes, real chiplets only) over the profiler's device time
of the kernels of `epoch_step.cu` named below, in percent."""
from perfbench.trace import kernel_time

KERNELS = r"\bepoch_\w*kernel"


def read(ctx):
    device_s = kernel_time(ctx.trace, KERNELS)
    bound = sum(c.info["kernel_bound_s"].get("epoch_step", 0.0)
                for c in ctx.traced_calls if c.info)
    if device_s <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / device_s
