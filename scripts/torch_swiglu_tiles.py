"""Times the w8a8 SwiGLU kernel of the PyTorch port against variants of it.

    python3 scripts/torch_swiglu_tiles.py [--variants 128:128,64:128,128:64,128:192:n,old=DIR]

Needs a CUDA card (an H100: the kernels are built for sm_90a). A variant
``gate_up:down[:n]`` is this checkout's ``vault_tpu_torch/csrc`` with
``swiglu_w8a8.cu``'s ``GATE_UP_BN`` and ``DOWN_BN`` (the tile widths of the
gate/up and the down products on the int8 core: 64, 128 or 192) set to
those numbers, and with ``:n`` ``ROWS_FIRST`` off (the work items walk N
fastest instead of the rows); a variant ``label=DIR`` is the csrc
directory DIR as it is, whose ``vt_swiglu_w8a8`` keeps this checkout's
signature. Each is built into ``build/swiglu_tiles/<variant>/`` with the
port's nvcc flags. Every variant runs through the port's own wrapper
(``ops/cuda_swiglu.py``, whose library loader is pointed at the variant's)
at the Llama-3-8B tower's widths (H 4,096, I 14,336, codes K-major) and
its rows at batch 16 (640) and 8 (320), bf16: held bit-equal to
``swiglu_block_w8a8_plain``, then timed by ``chip_smoke.device_ms``
(CUPTI, each trace held against the CUDA-event time of its calls), the
variants in turns (first to last, then last to first). Prints one JSON line
per row count with each variant's two device times and its time by device
kernel, then the card's name and power limit.
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
    """The variant's swiglu_w8a8 library, loaded."""
    from vault_tpu_torch.ops import _build

    label, _, src = variant.partition("=")
    out = ROOT / "build" / "swiglu_tiles" / label.replace(":", "_")
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(Path(src) if src else _build.CSRC, out)
    if not src:
        widths = label.split(":")
        source = out / "swiglu_w8a8.cu"
        text = source.read_text()
        edits = [("int GATE_UP_BN", widths[0]), ("int DOWN_BN", widths[1]),
                 ("bool ROWS_FIRST", "false" if widths[2:] == ["n"] else "true")]
        for name, value in edits:
            text, n = re.subn(rf"constexpr {name} = \w+;", f"constexpr {name} = {value};", text)
            if n != 1:
                raise RuntimeError(f"{name} not found once in swiglu_w8a8.cu")
        source.write_text(text)
    proc = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(out / "libswiglu_w8a8.so"),
                           str(out / "swiglu_w8a8.cu")], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"swiglu_w8a8.cu ({variant}) failed to build:\n{log}")
    regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
            if "Used" in ln or "spill" in ln]
    print(json.dumps({"variant": label, "ptxas": regs}), flush=True)
    return ctypes.CDLL(str(out / "libswiglu_w8a8.so"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="128:128,64:128,128:64,64:64,128:192,128:128:n")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_swiglu_tiles: no CUDA device")
    import chip_smoke as cs
    from vault_tpu_torch.ops import _build
    from vault_tpu_torch.ops import cuda_swiglu as sw

    variants = args.variants.split(",")
    libs = {v: build_variant(v) for v in variants}
    for lib in libs.values():
        for fn, (argtypes, restype) in sw._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        lib.vt_error_string.argtypes = [ctypes.c_int]
        lib.vt_error_string.restype = ctypes.c_char_p

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    o = cs.swiglu_operands(gen, dev)
    names = ("ln_w", "wgq", "sg", "wuq", "su", "wdq", "sd")
    for rows in (640, 320):
        x = torch.randn((rows, 4096), generator=gen, device=dev).to(torch.bfloat16)
        operands = [o[k] for k in names] + [x]
        ref = sw.swiglu_block_w8a8_plain(*operands)
        row = {"kernel": "swiglu_w8a8", "rows": rows, "ms": {}, "by_kernel": {}}
        for v in variants + variants[::-1]:
            key = v.partition("=")[0]
            _build.load = lambda name, signatures, _lib=libs[v]: _lib
            out = sw.fused_swiglu_block_fwd_w8a8(*operands)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                err = (out.float() - ref.float()).abs().max().item()
                sys.exit(f"torch_swiglu_tiles: rows={rows} {key}: max |kernel - plain| {err}, "
                         "expected bit-equal")
            ms, by_name = cs.device_ms(lambda: sw.fused_swiglu_block_fwd_w8a8(*operands),
                                       iters=10)
            row["ms"].setdefault(key, []).append(ms)
            row["by_kernel"][key] = by_name
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
