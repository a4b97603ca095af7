"""mlp_roofline.score: the MLP-block kernels' share of their roofline
while scoring, over every call of the operators of the fused MLP blocks
(``vault_tpu_torch::mlp_block`` and ``mlp_postln``, ViLT's pre-LN and the
text tower's post-LN block, and their w8a8 forms).  One call on x of R
rows of H and weights H × I and I × H: 4·R·H·I operations, at the int8
peak where the weights are int8 codes, else at the bf16 peak; every input
(x, the LayerNorm's and both linears' parameters, scales, a dropout mask)
read once, the output (x's size) written once."""

from portbench import roofline

OPERATORS = ("vault_tpu_torch::mlp_block", "vault_tpu_torch::mlp_postln",
             "vault_tpu_torch::mlp_block_w8a8", "vault_tpu_torch::mlp_postln_w8a8")


def match(name: str) -> bool:
    return name in OPERATORS


def least(trace, index: int):
    op = trace.ops[index]
    dims, types = op["args"]["Input Dims"], op["args"]["Input type"]
    x = 8 if op["name"].endswith("_w8a8") else 6
    h, i = dims[2]
    rows = 1
    for d in dims[x][:-1]:
        rows *= d
    peak = roofline.PEAK_INT8 if types[2] == "signed char" else roofline.PEAK_BF16
    nbytes = sum(roofline.tensor_bytes(op, j) for j in range(len(dims)))
    nbytes += roofline.tensor_bytes(op, x)
    return roofline.least_s(4.0 * rows * h * i, nbytes, peak)


def read(ctx):
    return roofline.share(ctx, match, least) if ctx.traffic["mode"] == "score" else None
