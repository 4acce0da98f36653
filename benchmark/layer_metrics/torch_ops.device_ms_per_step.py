"""torch_ops.device_ms_per_step: device time of every kernel, copy and
memset of the traced span other than the three force sweeps (the sort,
the cell and band build, the tables, the integrator and the graphs'
copies), in ms a step of the span."""


def read(ctx):
    span = ctx.trace
    if not span.ops or span.steps <= 0:
        return None
    return 1e3 * span.device_s(exclude=ctx.sweeps) / span.steps
