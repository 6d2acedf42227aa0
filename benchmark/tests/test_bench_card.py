"""The benchmark on the card: each cell's run at a short window is
correct, and both controls fail its limits (run on the chip:
`python -m pytest benchmark/tests -m cuda`; skips without a card)."""

import json
import os
import subprocess
import sys

import pytest

import compare

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["raw10_mix", "raw20_sparse"])
def test_cell_and_its_controls_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2147483999", "--seconds", "2", "--trace", "0",
         "--control", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    lim = compare.load_limits(workload)
    for name, ctl in res["control"].items():
        assert any(ctl[k] > lim[k] for k in compare.NUMBERS), (name, ctl)
