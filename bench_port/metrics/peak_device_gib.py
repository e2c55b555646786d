"""peak_device_gib: ``torch.cuda.max_memory_allocated`` over the window
(the peak is reset when it opens), in GiB."""


def read(ctx):
    peak = ctx.result["memory_peak_bytes"]
    return peak / 2 ** 30 if peak else None
