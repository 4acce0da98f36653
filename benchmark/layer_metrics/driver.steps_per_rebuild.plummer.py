"""driver.steps_per_rebuild.plummer: the window's steps over the band
rebuilds that Simulation.n_rebuilds counted in it, in the Plummer cell:
the dense core's rebuild cadence (a build redone at grown caps is not a
rebuild; none is redone in the window)."""


def read(ctx):
    if ctx.window_rebuilds <= 0:
        return None
    return ctx.window_steps / ctx.window_rebuilds
