"""k3_train_roofline: the training forward's K3 (the fused gather and
first FC that keeps its gathered rows) least time over its device time,
in %.  The range is the member-batched entry
``ta3n_tpu_torch.ops.gather_gemm.gathered_gemm_members``; the eval
forward's calls (``with_rows`` False) are left out.  Its work is
``yardstick.k3_work`` at the call's shapes."""

from bench_port.yardstick import PEAK_BY_DTYPE, bound, k3_work

RANGES = ("ta3n_tpu_torch.ops.gather_gemm:gathered_gemm_members",)


def read(ctx):
    calls = ctx.trace["ranges"].get(RANGES[0], [])
    peak = PEAK_BY_DTYPE[ctx.cell["traffic"]["compute_dtype"]]
    least = spent = 0.0
    for c in calls:
        args, kwargs = c["args"], c["kwargs"]
        with_rows = args[4] if len(args) > 4 else kwargs.get("with_rows",
                                                             True)
        if not with_rows:
            continue
        store, idx, weight = args[0], args[1], args[2]
        n, h, d = weight
        m = idx[0][-1]
        flops, nbytes = k3_work(m, d, h, n, True)
        least += bound(flops, nbytes, peak)[0] * 1e-3
        spent += c["device_s"]
    return 100.0 * least / spent if spent else None
