"""host_ms.train: the host's time in ms from the call into the program
(``Trainer.train_step``) to its return, as a mean over the measured
window's steps."""

import statistics


def read(ctx):
    if ctx.traffic["mode"] != "train" or not ctx.window["host_s"]:
        return None
    return 1e3 * statistics.fmean(ctx.window["host_s"])
