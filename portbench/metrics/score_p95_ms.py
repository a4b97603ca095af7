"""score_p95_ms: the 95th percentile (nearest rank) over every batch of the
measured window of the time from sending the batch to its logits being on
the host, in ms."""

import math


def read(ctx):
    lat = sorted(ctx.window["latency_s"])
    if ctx.traffic["mode"] != "score" or not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
