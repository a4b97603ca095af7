"""embed_host_ms.score: the host's time in ms per traced batch in the
embeddings: the summed durations of the program's ``vault.text_embed``
(the text tower's embeddings) and ``vault.vilt_embed`` (ViLT's joint
embedding: patchify, mask downsampling, position interpolation, patch
selection, the modality adds) spans in the traced window (program spans,
on the profiler's clock)."""

from portbench import spans

NAMES = ("vault.text_embed", "vault.vilt_embed")


def read(ctx):
    if ctx.traffic["mode"] != "score" or not ctx.traced_iters:
        return None
    found = [d for name in NAMES for d in spans.durations_us(ctx.trace, name)]
    return sum(found) / 1e3 / ctx.traced_iters if found else None
