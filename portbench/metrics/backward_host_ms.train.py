"""backward_host_ms.train: the host's time in ms per traced training step
in the program's ``vault.step.backward`` span: the backward
(``torch.autograd.grad``, which waits for autograd's device thread, and
under remat each layer's recompute) and the zero gradients of the
unreached leaves (program spans, on the profiler's clock)."""

from portbench import spans

NAME = "vault.step.backward"


def read(ctx):
    if ctx.traffic["mode"] != "train" or not ctx.traced_iters:
        return None
    found = spans.durations_us(ctx.trace, NAME)
    return sum(found) / 1e3 / ctx.traced_iters if found else None
