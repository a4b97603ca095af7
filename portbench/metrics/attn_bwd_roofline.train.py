"""attn_bwd_roofline.train: the encoder attention's backward kernel's share
of its roofline in a training step, over every call of the operator
``vault_tpu_torch::attention_bwd`` (ViLT's layers, whose attention draws no
dropout).  One call on q, k, v and the incoming gradient dO of (B, heads,
L, D) and a (B, 1, 1, L) key bias: the backward's four products (dV, dP,
dq, dk), 8·B·heads·L²·D operations at the bf16 peak (recomputing the
scores is the design's choice, not counted); q, k, v, the bias and dO read
once, dq, dk and dv (q's size each) written once."""

from portbench import roofline

OPERATOR = "vault_tpu_torch::attention_bwd"


def match(name: str) -> bool:
    return name == OPERATOR


def least(trace, index: int):
    op = trace.ops[index]
    b, h, l, d = op["args"]["Input Dims"][0]
    nbytes = (sum(roofline.tensor_bytes(op, i) for i in range(5))
              + 3 * roofline.tensor_bytes(op, 0))
    return roofline.least_s(8.0 * b * h * l * l * d, nbytes, roofline.PEAK_BF16)


def read(ctx):
    return roofline.share(ctx, match, least) if ctx.traffic["mode"] == "train" else None
