"""The card's tests (marked `cuda`; they skip where there is no card): a
sound run, the control and the planted faults at each cell's own size,
and one short run of each cell through its command."""

import json
import os
import subprocess
import sys

import pytest

from portbench.reference import compare

from . import tiny
from .conftest import ROOT

pytestmark = pytest.mark.cuda
CELLS = ["train_f32_b64", "train_bf16_b64"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_control_and_faults_at_the_cell_size(card, cell):
    """One seed at the cell's own size: the program within the cell's
    limits; the control and both planted faults outside them."""
    from portbench import calibrate

    seed = 3_000_000_029
    rows = calibrate.readings(cell, [seed], [seed], [seed], card)
    limits = tiny.limits(cell)
    judged = {r["kind"]: compare.judge(r, limits) for r in rows}
    assert judged == {"sound": True, "control": False, "half_batch": False, "unchanged": False}, rows


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_the_cell(card, cell):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "3000000031",
                           "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
    assert os.path.isdir(os.path.join(ROOT, "portbench", "_data"))
