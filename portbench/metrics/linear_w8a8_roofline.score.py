"""linear_w8a8_roofline.score: the w8a8 linear kernel's share of its
roofline while scoring, over every call of the operator
``vault_tpu_torch::linear_w8a8`` (in the w8a8 model BERT's q, k, v and
attention output projections and ViLT's attention output projection).  One
call on x (..., K) bf16, the codes (K, N) int8, the scales (1, N) fp32 and a
bias (N,) bf16 or none: 2·R·K·N operations at the int8 peak; every input
read once, the (R, N) output, in x's type, written once.  A program without
the operator reads nothing here."""

from portbench import roofline

OPERATOR = "vault_tpu_torch::linear_w8a8"


def match(name: str) -> bool:
    return name == OPERATOR


def least(trace, index: int):
    op = trace.ops[index]
    dims = op["args"]["Input Dims"]
    k, n = dims[1]
    rows = 1
    for d in dims[0][:-1]:
        rows *= d
    nbytes = sum(roofline.tensor_bytes(op, j) for j in range(len(dims)))
    nbytes += roofline.tensor_bytes(op, 0) // k * n  # the output, in x's type
    return roofline.least_s(2.0 * rows * k * n, nbytes, roofline.PEAK_INT8)


def read(ctx):
    return roofline.share(ctx, match, least) if ctx.traffic["mode"] == "score" else None
