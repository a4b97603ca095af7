"""optimizer_launches.train: the kernels launched per traced training step
inside the program's ``vault.step.optimizer`` span (AdamW's update of
every leaf, the gradients' cast where the step asks for it), by the launch
call's CUPTI correlation (device trace)."""

from portbench import spans

NAME = "vault.step.optimizer"


def read(ctx):
    if ctx.traffic["mode"] != "train" or not ctx.traced_iters:
        return None
    if not spans.in_window(ctx.trace, NAME):
        return None
    return spans.kernels_under(ctx.trace, NAME) / ctx.traced_iters
