"""near_span.roofline_pct: 100 x the least time of one near_span_kernel
launch on the segment's first band structure (benchmark/work.py: the
larger of 20 x live pairs over the float32 peak and its bytes over the
memory peak) over the mean device time of the launches of the traced
span that swept that structure.  The span starts with that structure,
which serves the first `serves` steps, one near sweep a step.

The live pairs are counted on the structure that the port's own band
build makes (harness.first_structure calls tools.common.first_rebuild,
sorted_padded and ops.forces.build_bands): a change to the band
classification, the adaptive rebuild or tools/common moves this
number's yardstick as well as the kernel's time, and is to be read as a
change to the yardstick."""


def read(ctx):
    launches = ctx.trace.durations("near_span_kernel")
    if not launches:
        return None
    first = ctx.first_structure()
    mine = launches[:max(1, min(first["serves"],
                                ctx.cell.traffic["frame_steps"]))]
    least, _ = first["least"]["near_span"]
    return 100.0 * least / (sum(mine) / len(mine))
