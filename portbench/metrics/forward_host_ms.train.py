"""forward_host_ms.train: the host's time in ms per traced training step
in the program's ``vault.step.forward`` span: the cast of the fp32
masters to bf16 (``vault.step.cast_params``), the forward and the loss
(program spans, on the profiler's clock)."""

from portbench import spans

NAME = "vault.step.forward"


def read(ctx):
    if ctx.traffic["mode"] != "train" or not ctx.traced_iters:
        return None
    found = spans.durations_us(ctx.trace, NAME)
    return sum(found) / 1e3 / ctx.traced_iters if found else None
