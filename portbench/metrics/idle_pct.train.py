"""idle_pct.train: the share of the traced window, in %, in which the device
ran no kernel, copy or fill (the union of their intervals)."""


def read(ctx):
    if ctx.traffic["mode"] != "train" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s())
