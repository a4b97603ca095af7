"""layer_host_us.score: the host's time in µs in one encoder layer: the
mean duration of the program's ``vault.layer`` spans (each encoder layer
of both towers) in the traced window (program spans, on the profiler's
clock)."""

import statistics

from portbench import spans


def read(ctx):
    if ctx.traffic["mode"] != "score":
        return None
    found = spans.durations_us(ctx.trace, "vault.layer")
    return statistics.fmean(found) if found else None
