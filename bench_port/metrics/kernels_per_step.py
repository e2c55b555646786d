"""kernels_per_step: the device kernels launched in the profiled epochs
(their training calls and validations), over the training steps in
them."""


def read(ctx):
    t = ctx.trace
    return t["kernels"] / t["steps"] if t["kernels"] and t["steps"] else None
