"""val_ms: the host time of an epoch's validation of every member (the
val split through the ensemble eval step, each batch's hits fetched), in
ms, the mean over the untraced window's epochs.  Read from the
benchmark's span around each validation, which starts after the epoch's
training has drained."""

from statistics import fmean


def read(ctx):
    spans = ctx.result["spans"].get("val")
    return fmean(spans) * 1e3 if spans else None
