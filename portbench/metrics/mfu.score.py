"""mfu.score: the model's products (``portbench/flops.py``) in the measured
window over its wall time, each against the peak of the precision it runs
in: the encoder linears at the int8 peak in a w8a8 configuration, every
other product at the bf16 peak; in %."""

from portbench import flops, roofline


def read(ctx):
    if ctx.traffic["mode"] != "score" or not ctx.window["iters"]:
        return None
    t = ctx.traffic
    kinds = flops.forward_products(ctx.cfg, t["batch"], t["text_positions"], tuple(t["canvas"]))
    dense_peak = roofline.PEAK_INT8 if ctx.cfg["quantize"] == "w8a8" else roofline.PEAK_BF16
    ideal = sum(f / (dense_peak if k == "dense" else roofline.PEAK_BF16) for k, f in kinds.items())
    return 100.0 * ideal * ctx.window["iters"] / ctx.window["seconds"]
