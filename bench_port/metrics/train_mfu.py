"""train_mfu: the matrix products' FLOPs of the untraced window's steps
and validations, from the shapes (``yardstick.step_flops`` times the
members), over the window's seconds and the peak of the cell's compute
dtype: 495/3 TFLOP/s for float32 run as 3xTF32, 989 for bfloat16, in %."""

from bench_port.yardstick import PEAK_BY_DTYPE


def read(ctx):
    r = ctx.result
    if not r["flops"] or not r["window_s"]:
        return None
    peak = PEAK_BY_DTYPE[ctx.cell["traffic"]["compute_dtype"]]
    return 100.0 * r["flops"] / r["window_s"] / peak
