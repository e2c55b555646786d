"""device_idle_pct: the share of the profiled window in which no kernel,
copy or set ran on the device, in %."""


def read(ctx):
    t = ctx.trace
    if not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
