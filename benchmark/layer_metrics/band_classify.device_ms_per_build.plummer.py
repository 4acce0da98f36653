"""band_classify.device_ms_per_build.plummer: the device time, in ms, of
the band_classify_kernel launches of the traced span (one a band build)
over their number: the classifier at the caps the dense core grew.  A
span that ran no band build has no classifier time and reads 0 (the
cell's 16-step span holds several builds)."""


def read(ctx):
    launches = ctx.trace.durations("band_classify_kernel")
    return 1e3 * sum(launches) / max(len(launches), 1)
