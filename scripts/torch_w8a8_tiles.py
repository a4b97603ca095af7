"""Times the w8a8 MLP kernels of the PyTorch port against variants of them.

    python3 scripts/torch_w8a8_tiles.py [--variants 128:64:128,192:64:128,128:64:128:r,old=DIR]

Needs a CUDA card (an H100: the kernels are built for sm_90a). A variant
``up:narrow:wide[:r]`` is this checkout's ``vault_tpu_torch/csrc`` with
``mlp_w8a8.cu``'s ``UP_BN`` (the first product's tile width on the int8
core: 64, 128 or 192), ``DOWN_NARROW`` and ``DOWN_WIDE`` (the widths the
second product picks from by waves, ``sm90::pick_tiling``) set to those
numbers, and with ``:r`` ``ROWS_FIRST`` on (the work items walk the rows
fastest); a variant ``label=DIR`` is the csrc
directory DIR as it is, such as a ``git archive`` of the parent commit,
whose ``vt_mlp_w8a8`` keeps this checkout's signature. Each is built into
``build/w8a8_tiles/<variant>/`` with the port's nvcc flags. Every variant
runs through the port's own wrappers (``ops/cuda_mlp.py``, whose library
loader is pointed at the variant's) at VAuLT-base's widths (H 768, I
3,072, codes K-major), the pre-LN block at ViLT's 2,048 rows of a batch-8
forward and the post-LN block at BERT's 320, bf16: held bit-equal to its
plain version, then timed by ``chip_smoke.device_ms`` (CUPTI, each trace
held against the CUDA-event time of its calls), the variants in turns
(first to last, then last to first). Prints one JSON line per block with
each variant's two device times and its time by device kernel, then the
card's name and power limit.
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
    """The variant's mlp_w8a8 library, loaded."""
    from vault_tpu_torch.ops import _build

    label, _, src = variant.partition("=")
    out = ROOT / "build" / "w8a8_tiles" / label.replace(":", "_")
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(Path(src) if src else _build.CSRC, out)
    if not src:
        fields = label.split(":")
        source = out / "mlp_w8a8.cu"
        text = source.read_text()
        edits = [("int UP_BN", fields[0]), ("int DOWN_NARROW", fields[1]),
                 ("int DOWN_WIDE", fields[2]),
                 ("bool ROWS_FIRST", "true" if fields[3:] == ["r"] else "false")]
        for name, value in edits:
            text, n = re.subn(rf"constexpr {name} = \w+;", f"constexpr {name} = {value};", text)
            if n != 1:
                raise RuntimeError(f"{name} not found once in mlp_w8a8.cu")
        source.write_text(text)
    proc = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(out / "libmlp_w8a8.so"),
                           str(out / "mlp_w8a8.cu")], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"mlp_w8a8.cu ({variant}) failed to build:\n{log}")
    regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
            if "Used" in ln or "spill" in ln]
    print(json.dumps({"variant": label, "ptxas": regs}), flush=True)
    return ctypes.CDLL(str(out / "libmlp_w8a8.so"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="128:64:128,192:64:128,64:64:128,128:128:128,"
                                          "128:64:192,128:64:128:r")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_w8a8_tiles: no CUDA device")
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from vault_tpu_torch.ops import _build
    from vault_tpu_torch.ops import cuda_mlp as cm

    variants = args.variants.split(",")
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc a variant, all at once
        libs = dict(zip(variants, pool.map(build_variant, variants)))
    for lib in libs.values():
        for fn, (argtypes, restype) in cm._W8A8_SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        lib.vt_error_string.argtypes = [ctypes.c_int]
        lib.vt_error_string.restype = ctypes.c_char_p

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    names = ("gamma", "beta", "w1q", "s1", "b1", "w2q", "s2", "b2", "x")
    for name, rows in (("mlp_block_w8a8", 2048), ("mlp_postln_w8a8", 320)):
        wrapper_name, plain_name = cs.INT8_KERNELS[name][:2]
        wrapper, plain = getattr(cm, wrapper_name), getattr(cm, plain_name)
        o = cs.int8_operands(gen, rows, torch.bfloat16, dev, w8a8=True)
        operands = [o[k] for k in names]
        ref = plain(*operands)
        row = {"kernel": name, "rows": rows, "ms": {}, "by_kernel": {}}
        for v in variants + variants[::-1]:
            key = v.partition("=")[0]
            _build.load = lambda lib_name, signatures, _lib=libs[v]: _lib
            out = wrapper(*operands)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                err = (out.float() - ref.float()).abs().max().item()
                sys.exit(f"torch_w8a8_tiles: {name} {key}: max |kernel - plain| {err}, "
                         "expected bit-equal")
            ms, by_name = cs.device_ms(lambda: wrapper(*operands), iters=20)
            row["ms"].setdefault(key, []).append(ms)
            row["by_kernel"][key] = by_name
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
