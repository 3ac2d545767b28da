"""chip_smoke.py's phases at tiny shapes on the CPU, and its refusal to run
anywhere but a GPU (the same check bench.py makes)."""

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from desmo_tpu import configs  # noqa: E402

SHAPE = (64, 24)


@pytest.fixture
def tiny_presets():
    """Tiny copies of two presets, registered under their own names for the
    CLI (which only takes preset names)."""
    names = []
    for base in ("cylinder", "aneurysm"):
        cfg = dataclasses.replace(configs.get(base), name=f"smoke_{base}", n=SHAPE[0], m=SHAPE[1])
        configs._register(cfg)
        names.append(cfg.name)
    yield tuple(names)
    for name in names:
        configs._PRESETS.pop(name)


def test_main_refuses_cpu_before_any_output(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert capsys.readouterr().out == ""


def test_bench_refuses_cpu_before_any_output(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_phase_cli_tiny(tmp_path, tiny_presets, capsys):
    out = chip_smoke.phase_cli(str(tmp_path), "cpu", presets=tiny_presets, epochs=200)
    assert set(out) == set(tiny_presets)
    assert all(np.isfinite(s["relative_error"]) for s in out.values())
    printed = capsys.readouterr().out
    assert printed.count("cli run smoke_") == 2 and "on [cpu]" in printed


def test_phase_presets_tiny(tmp_path):
    out = chip_smoke.phase_presets(
        str(tmp_path), presets=("cylinder", "fourier_cylinder", "ae_cylinder"),
        chunk=5, shape=SHAPE,
    )
    assert set(out) == {"cylinder", "fourier_cylinder", "ae_cylinder", "aneurysm_seeds4"}
    assert all(np.isfinite(v) and v > 0 for v in out.values())


def test_phase_trace_tiny_finds_both_x_contractions(tmp_path):
    times = chip_smoke.phase_trace(
        str(tmp_path), steps=3, shape=SHAPE, plane_prefix="/host:CPU"
    )
    assert times["fwd_us_per_step"] > 0 and times["bwd_us_per_step"] > 0
    assert times["events"]["fwd"] and times["events"]["bwd"]


def test_phase_mesh_tiny_on_four_devices(tmp_path):
    out = chip_smoke.phase_mesh(str(tmp_path), n_devices=4, chunk=5, shape=SHAPE)
    assert set(out) == {"aneurysm", "fourier_aneurysm"}


def test_hlo_scope_ops_forward_backward_and_fusions():
    hlo = """HloModule jit_f

%fused_computation.1 (param_0: f32[27,300]) -> f32[512,27] {
  %p = f32[27,300]{1,0} parameter(0)
  ROOT %dot.9 = f32[512,27]{1,0} dot(%p, %p), metadata={op_name="jit(f)/transpose(jvp(jit(f)))/x_contraction/transpose"}
}

ENTRY %main.3 (a.1: f32[512,27], x.1: f32[512,300]) -> f32[512,27] {
  %a.1 = f32[512,27]{1,0} parameter(0), metadata={op_name="a"}
  %dot_general.0 = f32[27,300]{1,0} dot(%a.1, %x.1), metadata={op_name="jit(f)/jvp(jit(f))/x_contraction/dot_general"}
  %other = f32[27,300]{1,0} add(%dot_general.0, %dot_general.0), metadata={op_name="jit(f)/add"}
  ROOT %fusion.2 = f32[512,27]{1,0} fusion(%other), kind=kOutput, calls=%fused_computation.1, metadata={op_name="jit(f)/mul"}
}
"""
    kinds = chip_smoke._hlo_scope_ops(hlo, "x_contraction")
    assert kinds["dot_general.0"] == "fwd"
    assert kinds["fusion.2"] == "bwd"
    assert "other" not in kinds and "a.1" not in kinds
