"""near_span.device_ms_per_step.plummer: the device time, in ms, of the
near_span_kernel launches of the traced span (the exact near band, one a
step) over the span's steps; nothing where the span launched none."""


def read(ctx):
    launches = ctx.trace.durations("near_span_kernel")
    if not launches or ctx.trace.steps <= 0:
        return None
    return 1e3 * sum(launches) / ctx.trace.steps
