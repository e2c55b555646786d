"""k2_roofline: K2's least time over its device time, in %.  The range
is the member-batched TRN backward's public entry,
``ta3n_tpu_torch.ops.trn_fused.trn_multiscale_bwd_members``: every
kernel launched inside a call counts, whatever its name.  Its work is
``yardstick.trn_work``'s backward at the call's shapes (x [N, B, S, D],
weights [N, H, k*D]) times the N members, at the 3xTF32 rate."""

from bench_port.yardstick import PEAK_BY_DTYPE, bound, trn_work

RANGES = ("ta3n_tpu_torch.ops.trn_fused:trn_multiscale_bwd_members",)


def read(ctx):
    calls = ctx.trace["ranges"].get(RANGES[0], [])
    peak = PEAK_BY_DTYPE[ctx.cell["traffic"]["compute_dtype"]]
    least = spent = 0.0
    for c in calls:
        n, b, s, d = c["args"][0]
        h = c["args"][1][0][1]
        flops, nbytes = trn_work(b, s, d, h)["trn_fused_bwd"]
        least += bound(n * flops, n * nbytes, peak)[0] * 1e-3
        spent += c["device_s"]
    return 100.0 * least / spent if spent else None
