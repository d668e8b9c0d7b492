"""The device's idle share of the traced window, in %: 1 - busy / wall,
busy the union of the device operations' intervals."""


def read(ctx):
    if not ctx["events"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
