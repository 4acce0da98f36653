"""table_sweep.roofline_pct: 100 x the least time of one
table_sweep_kernel launch on the segment's first band structure
(benchmark/work.py) over the device time of the traced span's first
launch, the far+mid evaluation of the span's first step, which sweeps
that structure.

The live pairs are counted on the structure that the port's own band
build makes (harness.first_structure calls tools.common.first_rebuild,
sorted_padded and ops.forces.build_bands): a change to the band
classification, the adaptive rebuild or tools/common moves this
number's yardstick as well as the kernel's time, and is to be read as a
change to the yardstick."""


def read(ctx):
    launches = ctx.trace.durations("table_sweep_kernel")
    if not launches:
        return None
    least, _ = ctx.first_structure()["least"]["table_sweep"]
    return 100.0 * least / launches[0]
