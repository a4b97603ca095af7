"""Times the w8a8 LN->QKV kernel of the PyTorch port at each tile width of its
int8 product.

    python3 scripts/torch_lnqkv_s8_tiles.py [--variants 64:192,128:192,64:64,128:128,192:192]

Needs a CUDA card (an H100: the kernels are built for sm_90a). A variant
``narrow:wide`` is this checkout's ``vault_tpu_torch/csrc`` with
``ln_qkv.cu``'s ``QKV_NARROW`` and ``QKV_WIDE`` (the two tile widths the
int8 product on the core picks from by waves, ``sm90::pick_tiling``: 64,
128 or 192) set to those numbers; ``w:w`` runs width w alone. Each is
built into ``build/lnqkv_s8_tiles/<variant>/`` with the port's nvcc
flags, all at once. Every variant runs through the port's own wrapper
(``ops/cuda_ln_qkv.py`` ``fused_ln_qkv_fwd_w8a8``, whose library loader is
pointed at the variant's) at ViLT-B/32's width (H 768, 3H 2,304, the codes
K-major), bf16, at the 2,048 rows of a batch-8 forward and the 4,096 of a
batch-16 one: held bit-equal to ``ln_qkv_w8a8_plain``, then timed by
``chip_smoke.device_ms`` (CUPTI, each trace held against the CUDA-event
time of its calls), the variants in turns (first to last, then last to
first). Prints one JSON line per row count with each variant's two device
times and its time by device kernel, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build_variant(variant: str) -> ctypes.CDLL:
    """The variant's ln_qkv library, loaded."""
    from vault_tpu_torch.ops import _build

    narrow, wide = variant.split(":")
    out = ROOT / "build" / "lnqkv_s8_tiles" / variant.replace(":", "_")
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    source = out / "ln_qkv.cu"
    text = source.read_text()
    for name, value in (("QKV_NARROW", narrow), ("QKV_WIDE", wide)):
        text, n = re.subn(rf"constexpr int {name} = \w+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise RuntimeError(f"{name} not found once in ln_qkv.cu")
    source.write_text(text)
    proc = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(out / "libln_qkv.so"),
                           str(source)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"ln_qkv.cu ({variant}) failed to build:\n{log}")
    regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
            if "Used" in ln or "spill" in ln]
    print(json.dumps({"variant": variant, "ptxas": regs}), flush=True)
    return ctypes.CDLL(str(out / "libln_qkv.so"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="64:192,128:192,64:64,128:128,192:192")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_lnqkv_s8_tiles: no CUDA device")
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from vault_tpu_torch.ops import _build
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    variants = args.variants.split(",")
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc a variant, all at once
        libs = dict(zip(variants, pool.map(build_variant, variants)))
    for lib in libs.values():
        for fn, (argtypes, restype) in cl._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        lib.vt_error_string.argtypes = [ctypes.c_int]
        lib.vt_error_string.restype = ctypes.c_char_p

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    names = cs.INT8_KERNELS["ln_qkv_w8a8"][2]
    for rows in (2048, 4096):
        o = cs.int8_operands(gen, rows, torch.bfloat16, dev, w8a8=True)
        operands = [o[k] for k in names]
        ref = cl.ln_qkv_w8a8_plain(*operands)
        row = {"kernel": "ln_qkv_w8a8", "rows": rows, "ms": {}, "by_kernel": {}}
        for v in variants + variants[::-1]:
            _build.load = lambda lib_name, signatures, _lib=libs[v]: _lib
            out = cl.fused_ln_qkv_fwd_w8a8(*operands)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                err = (out.float() - ref.float()).abs().max().item()
                sys.exit(f"torch_lnqkv_s8_tiles: {rows} rows {v}: max |kernel - plain| "
                         f"{err}, expected bit-equal")
            ms, by_name = cs.device_ms(lambda: cl.fused_ln_qkv_fwd_w8a8(*operands), iters=20)
            row["ms"].setdefault(v, []).append(ms)
            row["by_kernel"][v] = by_name
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
