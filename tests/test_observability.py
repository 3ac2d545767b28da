"""Metrics logging and profiling utilities."""

import csv
import json
import os

import numpy as np

from desmo_tpu.logging_utils import MetricsLogger
from desmo_tpu.profiling import StepTimer, debug_nans


def test_metrics_logger_csv_jsonl(tmp_path):
    with MetricsLogger(str(tmp_path), "run1", echo=False) as logger:
        for i in range(3):
            logger.log_epoch(i * 10, 100, {"rec": 0.5 / (i + 1), "ortho": 0.1, "l1": 2.0})
    with open(tmp_path / "run1.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3
    assert float(rows[0]["rec"]) == 0.5
    assert rows[2]["epoch"] == "20"
    with open(tmp_path / "run1.jsonl") as f:
        lines = [json.loads(l) for l in f]
    assert lines[1]["rec"] == 0.25


def test_reference_line_format():
    line = MetricsLogger.format_reference_line(
        40, 100000, {"rec": 1.58e-5, "ortho": 0.001, "l1": 3.5}
    )
    # the exact shape of the reference's epoch print (CYL:777)
    assert line.startswith("Epoch [41/100000], Rec Loss: 0.000015800000")
    assert "Spatial ortho loss: 0.00100000" in line
    assert "L1 loss: 3.5000" in line


def test_step_timer_and_fence():
    import jax.numpy as jnp

    t = StepTimer()
    x = jnp.ones((8, 8))
    t.start()
    y = x * 2
    t.stop(5, sync_tree={"a": y})  # waits for the device before the clock
    assert t.steps == 5
    assert t.seconds > 0
    assert np.isfinite(t.steps_per_sec)
    np.testing.assert_array_equal(np.asarray(y), 2.0)


def test_debug_nans_toggle():
    import jax

    debug_nans(True)
    assert jax.config.jax_debug_nans
    debug_nans(False)
    assert not jax.config.jax_debug_nans
