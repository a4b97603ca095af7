"""attn_roofline.score: the encoder attention kernel's share of its
roofline while scoring, over every call of the operator
``vault_tpu_torch::attention`` (both towers).  One call on q, k, v of
(B, heads, L, D) and a (B, 1, 1, L) key bias: 4·B·heads·L²·D operations
(q·kᵀ and p·v) at the bf16 peak; q, k, v and the bias read once, the
output (q's size) written once."""

from portbench import roofline

OPERATOR = "vault_tpu_torch::attention"


def match(name: str) -> bool:
    return name == OPERATOR


def least(trace, index: int):
    op = trace.ops[index]
    b, h, l, d = op["args"]["Input Dims"][0]
    nbytes = sum(roofline.tensor_bytes(op, i) for i in range(4)) + roofline.tensor_bytes(op, 0)
    return roofline.least_s(4.0 * b * h * l * l * d, nbytes, roofline.PEAK_BF16)


def read(ctx):
    return roofline.share(ctx, match, least) if ctx.traffic["mode"] == "score" else None
