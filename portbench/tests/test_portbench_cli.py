"""The command as a check runs it: without a card it exits with a code
other than 0 and prints no result, and so it does in a checkout that holds
only ``BENCHMARK.json`` and ``portbench/`` (no program to measure)."""

import os
import subprocess
import sys

import pytest

from conftest import REPO, copy_benchmark

ARGS = ["--workload", "bertweet-bf16.score_b256", "--seed", "7", "--seconds", "1",
        "--trace", "0"]


def command(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "benchmark alone"])
def test_no_result_without_a_card_or_a_program(tmp_path, where):
    cwd = REPO if where == "checkout" else tmp_path
    if where != "checkout":
        copy_benchmark(tmp_path)
    done = command(cwd)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
