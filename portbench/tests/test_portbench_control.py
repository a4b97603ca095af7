"""The control at each cell's own size, on the card: the reference one
precision below the configuration, put in the program's place, comes out
over a limit that the program's own reading stays under (and, for
training, so does a step that leaves half of each batch out).  Needs a
CUDA device: ``python3 -m pytest portbench/tests -m cuda``."""

import pytest
import torch

from portbench import calibrate, check
from portbench.spec import Spec

SEED = 2**32 + 77


def _readings(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = Spec()
    c = spec.cell(cell)
    cfg, traffic = spec.config(c["config"]), spec.traffic(c["traffic"])
    read = {"score": calibrate.score_readings, "train": calibrate.train_readings}
    rows = read[traffic["mode"]](cfg, traffic, SEED, torch.device("cuda", 0), True)
    limits = cfg["checks"][traffic["mode"]]
    return {r["side"]: check.judge({k: r[k] for k in limits}, limits) for r in rows}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bertweet-bf16.score_b256", "bert-w8a8.score_b256",
                                  "bertweet-bf16.train_b256"])
def test_the_control_fails_where_the_program_passes(cell):
    judged = _readings(cell)
    assert all(c["ok"] for c in judged.pop("program").values())
    assert judged and all(not all(c["ok"] for c in j.values()) for j in judged.values())
