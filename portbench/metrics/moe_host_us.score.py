"""moe_host_us.score: the host's time in µs in one MoE layer's expert
half: the mean duration of the program's ``vault.moe`` spans (routing,
the routed experts, the combine and the shared experts of each MoE layer
of the DeepSeek-V3 tower) in the traced window (program spans, on the
profiler's clock).  None where the program has no such span."""

import statistics

from portbench import spans


def read(ctx):
    if ctx.traffic["mode"] != "score":
        return None
    found = spans.durations_us(ctx.trace, "vault.moe")
    return statistics.fmean(found) if found else None
