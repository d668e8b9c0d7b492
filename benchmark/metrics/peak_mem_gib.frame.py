"""Peak device memory allocated in the window, in GiB
(torch.cuda.max_memory_allocated after a reset at the window's start)."""


def read(ctx):
    return ctx["peak_window_bytes"] / 2 ** 30
