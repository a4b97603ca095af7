"""train_pairs_per_s: every pair trained in the measured window over the
window's seconds (the window ends when the last step's loss is on the
host)."""


def read(ctx):
    if ctx.traffic["mode"] != "train" or not ctx.window["iters"]:
        return None
    return ctx.window["iters"] * ctx.traffic["batch"] / ctx.window["seconds"]
