"""host_ms.score: the host's time in ms from the call into the program
(``VaultForClassification.forward``) to its return, before the
logits are fetched, as a mean over the measured window's batches."""

import statistics


def read(ctx):
    if ctx.traffic["mode"] != "score" or not ctx.window["host_s"]:
        return None
    return 1e3 * statistics.fmean(ctx.window["host_s"])
