"""layer_idle_ms.score: the device's idle time in ms per traced batch in
the gaps that began while the host was inside one of the program's
``vault.layer`` spans (each encoder layer of both towers; a gap goes to
the innermost program span open when it began) (device trace)."""

from portbench import spans

NAME = "vault.layer"


def read(ctx):
    if ctx.traffic["mode"] != "score" or not ctx.traced_iters:
        return None
    if not spans.in_window(ctx.trace, NAME):
        return None
    return 1e3 * spans.idle_by_span(ctx.trace).get(NAME, 0.0) / ctx.traced_iters
