"""moe_launches.score: the kernels launched per MoE layer, those whose
launch call ran inside one of the program's ``vault.moe`` spans in the
traced window (by the launch's CUPTI correlation), over the number of
those spans (device trace).  None where the program has no such span."""

from portbench import spans

NAME = "vault.moe"


def read(ctx):
    if ctx.traffic["mode"] != "score":
        return None
    layers = len(spans.in_window(ctx.trace, NAME))
    return spans.kernels_under(ctx.trace, NAME) / layers if layers else None
