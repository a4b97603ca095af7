"""moe_roofline.score: the routed experts' grouped kernel's share of its
roofline while scoring, over every call of the operator
``vault_tpu_torch::moe_experts`` (each MoE layer of the DeepSeek-V3 tower).
One call on the routed rows x (R, H), gate and up (E, I, H) and down (E,
H, I): 2·R·3·H·I operations (the gate, up and down products of every
routed row) at the bf16 peak; every held expert's weights read once, the
rows read once, the (R, H) output written once, the (R, I) intermediate
between the call's two launches written and read once, the offsets and
the route weights read once.  R, H, I and E come from the operator's
input dimensions alone."""

from portbench import roofline

OPERATOR = "vault_tpu_torch::moe_experts"
TYPE_BYTES = {**roofline.DTYPE_BYTES, "int": 4}


def match(name: str) -> bool:
    return name == OPERATOR


def least(trace, index: int):
    op = trace.ops[index]
    dims, types = op["args"]["Input Dims"], op["args"]["Input type"]
    (r, h), (e, i, _) = dims[0], dims[1]
    size = [TYPE_BYTES[t] for t in types]
    nbytes = (r * h * size[0] * 2                   # x read, out written
              + e * i * h * (size[1] + size[2]) + e * h * i * size[3]
              + r * i * size[0] * 2                 # the intermediate, written and read
              + (e + 1) * size[4] + r * size[5])
    return roofline.least_s(6.0 * r * h * i, nbytes, roofline.PEAK_BF16)


def read(ctx):
    return roofline.share(ctx, match, least) if ctx.traffic["mode"] == "score" else None
