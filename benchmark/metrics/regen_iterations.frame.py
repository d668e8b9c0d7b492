"""Regen loop iterations per frame: the change of the program's counter
``render_radiance_regen.iterations`` over the traced window."""

COUNTERS = ["gdpathtracing_torch.render.regen:render_radiance_regen"
            ".iterations"]


def read(ctx):
    return ctx["counters"][COUNTERS[0]] / ctx["steps"]
