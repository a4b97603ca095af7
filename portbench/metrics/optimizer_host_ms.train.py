"""optimizer_host_ms.train: the host's time in ms per traced training step
in the program's ``vault.step.optimizer`` span: the gradients' cast, where
the step asks for it, and AdamW's update of every leaf (``tx.step_``)
(program spans, on the profiler's clock)."""

from portbench import spans

NAME = "vault.step.optimizer"


def read(ctx):
    if ctx.traffic["mode"] != "train" or not ctx.traced_iters:
        return None
    found = spans.durations_us(ctx.trace, NAME)
    return sum(found) / 1e3 / ctx.traced_iters if found else None
