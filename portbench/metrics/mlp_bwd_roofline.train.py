"""mlp_bwd_roofline.train: the MLP blocks' backward share of its roofline
in a training step, over every call of the fused MLP block's backward
(the autograd node ``_FusedMLPBackward``: the backward kernels of both
towers' blocks and the weight-gradient products they leave to cuBLAS).
One call for a forward on x of R rows of H and weights H × I and I × H:
the backward's four products, 8·R·H·I operations at the bf16 peak
(recomputing the forward's first product is the design's choice, not
counted); x, the incoming gradient, the dropout mask and the parameters
read once; the gradients of x and of every parameter written once.  The
shapes are those of the forward call the node belongs to."""

from portbench import roofline

NODE = "_FusedMLPBackward"
FORWARD = "_FusedMLP"


def match(name: str) -> bool:
    return name.endswith(NODE)


def least(trace, index: int):
    fwd = trace.forward_of(index, FORWARD)
    if fwd is None:
        return None
    dims = fwd["args"]["Input Dims"]
    h, i = dims[2]
    rows = 1
    for d in dims[6][:-1]:
        rows *= d
    params = sum(roofline.tensor_bytes(fwd, j) for j in range(6))
    x = roofline.tensor_bytes(fwd, 6)
    nbytes = 2 * params + 3 * x + roofline.tensor_bytes(fwd, 7)
    return roofline.least_s(8.0 * rows * h * i, nbytes, roofline.PEAK_BF16)


def read(ctx):
    return roofline.share(ctx, match, least) if ctx.traffic["mode"] == "train" else None
