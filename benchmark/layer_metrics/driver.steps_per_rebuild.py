"""driver.steps_per_rebuild: the window's steps over the band rebuilds
that Simulation.n_rebuilds counted in it (the adaptive runner's count;
a per-step rebuild counts none, and then nothing is read)."""


def read(ctx):
    if ctx.window_rebuilds <= 0:
        return None
    return ctx.window_steps / ctx.window_rebuilds
