"""Device operations (kernels, copies, fills) per unit of the traced
window: the host glue's launches, from the device trace."""


def read(ctx):
    return len(ctx["events"]) / ctx["steps"] if ctx["events"] else None
