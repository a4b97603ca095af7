"""The readings that a cell's limits are set from, on the card and at the
cell's own size (``PERF.md`` lists them beside each limit):

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... [--control 11,12,13]

For each seed, in one process: the program's readings as a run takes them
(scoring: ``check_batches`` batches through the timed loop, compared with
the reference; training: the first steps through ``Trainer.train_step``),
and for the seeds of ``--control`` the control's: the reference one
precision below the configuration (``checks.control`` of its file,
straight-through for training) in the program's place.  A training cell
also reads the fault of half of each batch left out of the loss (the
reference in the program's place); a step that returns its state
unchanged reads 1 by ``delta_gap``'s measure and needs no run.  One JSON
line per reading on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402  (puts the repository on the path first)


def score_readings(cfg, traffic, seed, device, control: bool) -> list:
    from portbench import check

    model, make, first = run.build_scorer(cfg, traffic, seed, device, [])
    got = run.score_loop(model, make, first, run.count(traffic["check_batches"]))
    del model
    run._free(device)
    idx = got["indices"]
    ref = check.score_reference(cfg, traffic, seed, idx, device, check.reference_prec(cfg))
    out = [{"side": "program", "logit_gap": max(check.logit_gap(got["logits"][i], ref[i])
                                                 for i in idx)}]
    if control:
        low = check.score_reference(cfg, traffic, seed, idx, device, cfg["checks"]["control"])
        out.append({"side": "control", "logit_gap": max(check.logit_gap(low[i], ref[i])
                                                         for i in idx)})
    return out


def train_readings(cfg, traffic, seed, device, control: bool) -> list:
    from portbench import check

    trainer, _, _, prog = run.build_trainer(cfg, traffic, seed, device, [])
    del trainer
    run._free(device)
    ref = check.train_reference(cfg, traffic, seed, device, check.reference_prec(cfg))
    out = [{"side": "program", **check.train_gaps(prog, ref)}]
    if control:
        low = check.train_reference(cfg, traffic, seed, device, cfg["checks"]["control"],
                                    ste=True)
        out.append({"side": "control", **check.train_gaps(low, ref)})
        half = check.train_reference(cfg, traffic, seed, device, check.reference_prec(cfg),
                                     rows=traffic["batch"] // 2)
        out.append({"side": "fault: half of each batch left out", **check.train_gaps(half, ref)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", default="", help="comma-separated seeds for the control")
    args = p.parse_args(argv)
    import torch

    from portbench.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    read = {"score": score_readings, "train": train_readings}[traffic["mode"]]
    controls = {int(s) for s in args.control.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        for reading in read(cfg, traffic, seed, device, seed in controls):
            print(json.dumps({"workload": args.workload, "seed": seed, **reading}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
