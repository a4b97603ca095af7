"""score_pairs_per_s: every pair classified in the measured window over
the window's seconds (its logits on the host)."""


def read(ctx):
    if ctx.traffic["mode"] != "score" or not ctx.window["iters"]:
        return None
    return ctx.window["iters"] * ctx.traffic["batch"] / ctx.window["seconds"]
