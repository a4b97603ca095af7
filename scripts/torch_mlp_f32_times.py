"""Times the fp32 MLP blocks of the PyTorch port, in this checkout and in
other trees of the repository, on the card, in turns.

    python3 scripts/torch_mlp_f32_times.py --trees parent=DIR,tree=. [--order parent,tree,tree,parent]

Needs a CUDA card (an H100: the kernels are built for sm_90a).  ``--trees``
names each tree (``label=DIR``, DIR a checkout or an unpacked ``git
archive`` of one); ``--order`` the turns (default: the first tree, the
second, the second, the first).  Each turn is a process of its own with
that tree's ``vault_tpu_torch`` first on the path, so its wrappers and its
kernels (built into its own ``build/``) run; the operands, the checks and
the timing come from this checkout's ``chip_smoke.py`` (``mlp_operands``,
``int8_operands``, ``device_ms``: CUPTI, each trace held against the
CUDA-event time of its calls).  Each turn runs the six fp32 blocks at H 768
/ I 3,072 at their main path's rows (``chip_smoke.TILES_ROWS``: forward
2,048 pre-LN and 320 post-LN rows, with fp32 or int8 weights; backward
8,192 and 1,280 rows), holds each to its plain version (forward 1e-4,
backward 1e-4 of max(1, max|plain|) per output) and prints one JSON line
per block with its device ms and its time by device kernel.  The last lines
are a table of each block's ms per turn and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def chip_smoke():
    """This checkout's chip_smoke.py, loaded by path (the tree under test
    may hold its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_times", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: Path, label: str):
    sys.path.insert(0, str(tree.resolve()))
    import torch

    from vault_tpu_torch.ops import _build
    from vault_tpu_torch.ops import cuda_mlp as cm

    if not str(Path(cm.__file__).resolve()).startswith(str(tree.resolve())):
        sys.exit(f"torch_mlp_f32_times: {label} imported {cm.__file__}, not from {tree}")
    cs = chip_smoke()
    _build.build_all()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(5)
    for name, rows in cs.TILES_ROWS.items():
        postln = "postln" in name
        q8, bwd = name.endswith("_q8"), name.endswith("_bwd")
        if q8:
            o = cs.int8_operands(gen, rows, torch.float32, dev)
            args = [o[k] for k in cs.INT8_KERNELS[name][2]]
            run = lambda: getattr(cm, cs.INT8_KERNELS[name][0])(*args)
            ref = getattr(cm, cs.INT8_KERNELS[name][1])(*args)
        else:
            x, o, m = cs.mlp_operands(gen, rows, torch.float32, dev, postln)
            if bwd:
                g = torch.randn((rows, 768), generator=gen, device=dev)
                args = (o["gamma"], o["beta"], o["w1"], o["b1"], o["w2"], o["b2"], x, g, m)
                wrapper = cm.fused_mlp_postln_block_bwd if postln else cm.fused_mlp_block_bwd
                plain = cm.mlp_postln_bwd_plain if postln else cm.mlp_block_bwd_plain
                run, ref = (lambda: wrapper(*args)), plain(*args)
            else:
                kernel = cm.fused_mlp_postln_fwd if postln else cm.fused_mlp_block_fwd
                plain = cm._mlp_postln_plain if postln else cm._mlp_block_plain
                run = lambda: kernel(o["gamma"], o["beta"], o["w1"], o["b1"], o["w2"],
                                     o["b2"], x, m, eps=1e-12)
                ref = plain({"scale": o["gamma"], "bias": o["beta"]}, {"w": o["w1"], "b": o["b1"]},
                            {"w": o["w2"], "b": o["b2"]}, x, 1e-12, "gelu", m)
        out = run()
        torch.cuda.synchronize()
        outs, refs = (out, ref) if bwd else ((out,), (ref,))
        for a, b in zip(outs, refs):
            scale = max(1.0, b.abs().max().item()) if bwd else 1.0
            err = (a - b).abs().max().item() / scale
            if not err <= 1e-4:
                sys.exit(f"torch_mlp_f32_times: {label} {name}: |kernel - plain| {err} > 1e-4")
        timed = (lambda: cm._launch_bwd(postln, *args, 1e-12)) if bwd else run
        ms, by_kernel = cs.device_ms(timed, iters=5 if bwd else 20)
        print(json.dumps({"turn": label, "kernel": name, "rows": rows, "ms": ms,
                          "by_kernel": by_kernel}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", default="parent=build/parent,tree=.")
    ap.add_argument("--order", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(Path(args.worker), args.label)
    trees = dict(t.split("=", 1) for t in args.trees.split(","))
    labels = list(trees)
    order = args.order.split(",") if args.order else [labels[0], labels[-1], labels[-1],
                                                      labels[0]]
    table = {}
    for i, label in enumerate(order):
        proc = subprocess.run([sys.executable, __file__, "--worker", trees[label], "--label",
                               label], capture_output=True, text=True, cwd=ROOT)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.exit(f"torch_mlp_f32_times: turn {i} ({label}) failed:\n{proc.stderr[-4000:]}")
        for line in proc.stdout.splitlines():
            row = json.loads(line)
            table.setdefault(row["kernel"], []).append([label, row["ms"]])
    print(json.dumps({"ms_by_turn": table}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
