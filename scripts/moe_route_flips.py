"""How the Moonlight cell's check reads the program, on the card:

    python3 scripts/moe_route_flips.py --seeds 3000000105[,...] [--tie 0.0039] [--alone]

For each seed, as ``portbench/calibrate.py`` does it: the cell's program
(``VaultWithDeepseekTower``, its weights and inputs made from the seed as
a run makes them) scores ``check_batches`` batches, and the family's
reference (``portbench/families/vault_moe/reference.py``) computes them
in fp32, following the program's routes at a tie (``--tie``, in units of
sigmoid score + bias; the reference's ``TIE`` by default), and again on
fp8 codes (the control).  One JSON line a seed with:

  * ``logit_gap``: the program's and the control's against the reference;
    the faults', read against the reference alone: ``stale`` (each batch
    answered with the one before), ``half_zero`` and ``half_copied`` (the
    second half of each batch answered with zeros, or with the first
    half's logits); with ``--alone``, the program against the reference
    choosing every route itself (the check as it read before it followed
    the program);
  * per MoE layer, for the reference and the control: ``followed``, the
    share of rows whose six experts it took from the program where its own
    six differ; ``refused``, the share it chose itself because the
    program's were not within the tie; ``shortfall``, the largest distance
    of a followed row's lowest chosen score below its own sixth.

Then the card's name and power limit.  Needs a CUDA card with 40 GB free.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import check, families, run  # noqa: E402
from portbench.families.vault_moe import routes  # noqa: E402
from portbench.spec import Spec  # noqa: E402

CELL = "moonlight-bf16.score_b256"


def per_layer(seen: list) -> dict:
    return {k: [round(s[k], 6) for s in seen] for k in ("followed", "refused", "shortfall")}


def one_seed(cfg, traffic, seed: int, device, tie, alone: bool) -> dict:
    model, make, first = run.build_scorer(cfg, traffic, seed, device, [])
    got = run.score_loop(model, make, first, run.count(traffic["check_batches"]))
    del model
    run._free(device)
    idx = got["indices"]
    ref = families.load(cfg, "reference")
    if tie is not None:
        ref.TIE = tie
    seen, seen_control = [], []
    want = ref.score_reference(cfg, traffic, seed, idx, device, seen=seen)
    low = ref.score_reference(cfg, traffic, seed, idx, device, cfg["checks"]["control"],
                              seen=seen_control)

    def worst(pairs):
        return max(check.logit_gap(a, b) for a, b in pairs)

    half = traffic["batch"] // 2
    gaps = {"program": worst((got["logits"][i], want[i]) for i in idx),
            "control": worst((low[i], want[i]) for i in idx),
            "stale": worst((want[a], want[b]) for a, b in zip(idx[:-1], idx[1:])),
            "half_zero": worst((np.zeros_like(want[i][half:]), want[i][half:]) for i in idx),
            "half_copied": worst((want[i][:half], want[i][half:]) for i in idx)}
    if alone:
        routes.leave(None)
        own = ref.score_reference(cfg, traffic, seed, idx, device)
        gaps["program_alone"] = worst((got["logits"][i], own[i]) for i in idx)
    return {"seed": seed, "tie": ref.TIE, "batches": idx, "logit_gap": gaps,
            "reference_logit_std": float(np.concatenate([want[i] for i in idx]).std()),
            "reference": per_layer(seen),
            "control": per_layer(seen_control)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--tie", type=float, default=None)
    p.add_argument("--alone", action="store_true")
    args = p.parse_args(argv)
    spec = Spec()
    cell = spec.cell(CELL)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(one_seed(cfg, traffic, seed, device, args.tie, args.alone)),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": smi.stdout.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
