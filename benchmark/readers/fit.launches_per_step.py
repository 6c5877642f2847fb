"""fit.launches_per_step: kernel launches the device ran in the profiled
training run (one epoch with its evaluation), per training step."""


def read(ctx):
    p = ctx.profile
    steps = ctx.counts.get("steps")
    if p is None or not steps or p.kernels == 0:
        return None
    return p.kernels / steps
