"""host_paced_videos_per_s: ``train_videos_per_s`` of the traced run's
untraced window (real source videos of its steps times the members, over
its seconds), for a cell whose window is paced by the host's speed too
unsteadily to bound it end to end."""


def read(ctx):
    return ctx.result["end_to_end"].get("train_videos_per_s")
