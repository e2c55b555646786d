"""device_mfu: the matrix products' FLOPs of the profiled epochs (their
training steps and validations, from the shapes: ``yardstick.window_flops``)
over the device's busy seconds in them and the peak of the cell's compute
dtype, in %: the whole step's share of the chip's peak while the device
works, beside the kernels' rooflines; ``device_ms_per_step`` is the time
it divides by."""

from bench_port.yardstick import PEAK_BY_DTYPE


def read(ctx):
    t = ctx.trace
    if not t["busy_s"] or not t.get("flops"):
        return None
    peak = PEAK_BY_DTYPE[ctx.cell["traffic"]["compute_dtype"]]
    return 100.0 * t["flops"] / t["busy_s"] / peak
