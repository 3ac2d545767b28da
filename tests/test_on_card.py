"""On-card tests: they need an NVIDIA GPU and skip elsewhere.

    python -m pytest tests/ -m gpu
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_platform, tmp_path):
    """chip_smoke.py end to end on the card: every phase passes and the last
    line names the GPU."""
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", "--out", str(tmp_path)],
        cwd=REPO, env=gpu_platform, capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] == 1
