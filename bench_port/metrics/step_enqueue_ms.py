"""step_enqueue_ms: the host time from an epoch call's entry
(``make_ensemble_multi_step``'s call) until it returns, over its steps, in
ms, the mean over the untraced window's epochs; no synchronisation is
added, so it is the host's dispatch of a step, not the device's time."""

from statistics import fmean


def read(ctx):
    spans = ctx.result["spans"].get("step_enqueue")
    return fmean(spans) * 1e3 if spans else None
