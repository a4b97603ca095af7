"""Times the bf16 attention kernel of the PyTorch port against variants of it.

    python3 scripts/torch_attention_tiles.py [--variants 64:2,64:3,128:2,old=DIR]

Needs a CUDA card (an H100: the kernels are built for sm_90a). A variant
``keys:stages`` is this checkout's ``vault_tpu_torch/csrc`` with
``attention_common.cuh``'s ``KEYS`` (the key tile: 64 or 128, the widths the
core has a ``wgmma`` wrapper for) and ``MAX_STAGES`` (the deepest ring of
K/V stages) set to those numbers; a variant ``label=DIR`` is the csrc
directory DIR as it is (for example that of another commit, unpacked with
``git archive``), whose attention entries keep this checkout's signatures.
Each is built into ``build/attention_tiles/<variant>/`` with the port's nvcc
flags. Every variant runs through the port's own wrappers
(``ops/cuda_attention.py``, whose library loader is pointed at the
variant's), at the main path's shapes and the longer lengths
``chip_smoke.py`` checks: held against the plain version (``chip_smoke``'s
bf16 limits, ``LIMITS`` and ``ATTENTION_ROW_LIMIT``), then timed by
``chip_smoke.device_ms`` (CUPTI, each trace held against the CUDA-event time
of its calls), the variants in turns (first to last, then last to first).
Prints one JSON line per shape with each variant's two device times, then
the card's name and power limit.
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


def build_variant(variant: str):
    """The variant's two libraries (attention, attention_gqa), loaded."""
    from vault_tpu_torch.ops import _build

    label, _, src = variant.partition("=")
    out = ROOT / "build" / "attention_tiles" / label.replace(":", "_")
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(Path(src) if src else _build.CSRC, out)
    if not src:
        keys, stages = label.split(":")
        common = out / "attention_common.cuh"
        text = common.read_text()
        for name, value in (("KEYS", keys), ("MAX_STAGES", stages)):
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text)
            if n != 1:
                raise RuntimeError(f"{name} not found once in attention_common.cuh")
        common.write_text(text)
    procs = {name: subprocess.Popen([_build.nvcc(), *_build.FLAGS, "-o",
                                     str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in ("attention", "attention_gqa")}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}.cu ({variant}) failed to build:\n{log}")
        regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines() if "Used" in ln]
        print(json.dumps({"variant": label, "source": name, "ptxas": regs}),
              flush=True)
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="64:2,64:3,128:2")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_attention_tiles: no CUDA device")
    import chip_smoke as cs
    from vault_tpu_torch.ops import _build
    from vault_tpu_torch.ops import cuda_attention as ca

    variants = args.variants.split(",")
    libs = {v: build_variant(v) for v in variants}
    sigs = {"attention": ca._SIGNATURES, "attention_gqa": ca._GQA_SIGNATURES}
    for v in variants:
        for name, lib in libs[v].items():
            for fn, (argtypes, restype) in sigs[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            lib.vt_error_string.argtypes = [ctypes.c_int]
            lib.vt_error_string.restype = ctypes.c_char_p

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    cases = [("encoder_attention", (8, 12, 40, 64)), ("encoder_attention", (8, 12, 256, 64)),
             ("encoder_attention", (8, 12, 281, 64)), ("encoder_attention", (8, 12, 512, 64)),
             ("attention_gqa", (16, 32, 8, 40, 128)), ("attention_gqa", (4, 32, 8, 300, 128))]
    for kernel, shape in cases:
        if kernel == "encoder_attention":
            b, h, l, d = shape
            operands = cs.attention_case(gen, b, h, l, bf, dev, fused=True, d=d)
            fn, plain, lib_name = ca.fused_attention, ca.attention_plain, "attention"
        else:
            b, h, g, l, d = shape
            operands = cs.gqa_case(gen, b, h, g, l, d, bf, dev)
            fn, plain, lib_name = ca.fused_attention_gqa, ca.attention_gqa_plain, "attention_gqa"
        ref = plain(*operands)
        row = {"kernel": kernel, "shape": list(shape), "ms": {}, "max_abs_err": {},
               "device_kernels": {}}
        for v in variants + variants[::-1]:
            key = v.partition("=")[0]
            _build.load = lambda name, signatures, _lib=libs[v][lib_name]: _lib
            out = fn(*operands)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            row_err = cs.attention_row_err(out, ref)
            if not (err <= cs.LIMITS["bfloat16"] and row_err <= cs.ATTENTION_ROW_LIMIT):
                sys.exit(f"torch_attention_tiles: {kernel} {shape} {key}: max |kernel - plain| "
                         f"{err}, by rows {row_err}")
            ms, by_name = cs.device_ms(lambda: fn(*operands))
            row["ms"].setdefault(key, []).append(ms)
            row["max_abs_err"][key] = err
            row["device_kernels"][key] = sorted(by_name)
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
