"""Share of the step inside ``torch.autograd.grad``, in %: the
benchmark's own spans around its two calls, each boundary synchronised."""


def read(ctx):
    grad = ctx["spans"].get("autograd.grad")
    if not grad:
        return None
    return 100.0 * sum(grad) / ctx["window_s"]
