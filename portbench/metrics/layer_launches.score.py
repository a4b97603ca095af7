"""layer_launches.score: the kernels launched per encoder layer, those
whose launch call ran inside one of the program's ``vault.layer`` spans in
the traced window (by the launch's CUPTI correlation), over the number of
those spans (device trace)."""

from portbench import spans

NAME = "vault.layer"


def read(ctx):
    if ctx.traffic["mode"] != "score":
        return None
    layers = len(spans.in_window(ctx.trace, NAME))
    return spans.kernels_under(ctx.trace, NAME) / layers if layers else None
