"""mfu.train: a training step's model products, 3× the forward's
(``portbench/flops.py``; remat's recomputation is not model work), in the
measured window over its wall time, against the bf16 peak; in %."""

from portbench import flops, roofline


def read(ctx):
    if ctx.traffic["mode"] != "train" or not ctx.window["iters"]:
        return None
    t = ctx.traffic
    step = flops.train_step_flops(ctx.cfg, t["batch"], t["text_positions"], tuple(t["canvas"]))
    return 100.0 * step / roofline.PEAK_BF16 * ctx.window["iters"] / ctx.window["seconds"]
