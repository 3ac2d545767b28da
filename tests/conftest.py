"""Test environment: force CPU with 8 virtual devices for sharding tests.

Must run before the first `import jax` anywhere in the test session.
"""

import os

# Tests run on an 8-device virtual CPU mesh; code that needs the card is
# exercised by chip_smoke.py and bench.py on the GPU.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# This jaxlib's CPU backend compiles tiny executables slowly (~10s for the
# first op-by-op eval); a persistent cache (inside the checkout, like the
# program's own default) makes repeat test runs cheap.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Two test tiers: the default run (`pytest tests/ -q`) excludes tests marked
# slow (via addopts in pyproject.toml) and finishes in ~3 min; the full suite
# (`pytest tests/ -m '' -q`) adds the trajectory-parity / end-to-end
# heavyweights listed here. Measured cutoff:
# anything >= ~5 s per --durations on the 8-device CPU mesh. Kept as one
# central list (not scattered decorators) so re-tiering after a profiling run
# is a single edit.
# ---------------------------------------------------------------------------
_SLOW = {
    "tests/test_ae.py::test_ae_training_converges",
    "tests/test_ae.py::test_live_init_has_gradient_flow",
    "tests/test_ensemble_fourier.py::test_fit_packed_period_multistart_rescues_mismatch",
    "tests/test_ensemble_fourier.py::test_packed_fourier_grad_matches_per_seed",
    "tests/test_ensemble_fourier.py::test_trajectory_parity_fourier",
    "tests/test_fourier.py::test_period_multistart_rescues_mismatch",
    "tests/test_golden_forward.py::test_fourier_checkpoint_forward_parity",
    "tests/test_graft_entry.py::test_dryrun_multichip_subprocess",
    "tests/test_graft_entry.py::test_nonfinite_loss_detection",
    "tests/test_ingest_formats.py::test_cli_run_from_on_disk_series",
    "tests/test_model.py::test_factored_loss_matches_direct",
    "tests/test_model.py::test_loss_is_differentiable_everywhere",
    "tests/test_parallel.py::test_space_mesh_matches_single_device",
    "tests/test_runner.py::test_aneurysm_voxel_celldata_run",
    "tests/test_runner.py::test_cli_mesh_run",
    "tests/test_runner.py::test_run_ae_recipe",
    "tests/test_runner.py::test_run_all_variants",
    "tests/test_runner.py::test_run_with_device_mesh_fourier_sharded",
    "tests/test_runner.py::test_run_with_device_mesh_scan_fallback",
    "tests/test_runner.py::test_run_with_device_mesh_sharded_kernel",
    "tests/test_runner.py::test_run_mesh_with_seeds",
    "tests/test_runner.py::test_graceful_preemption_end_to_end",
    "tests/test_runner.py::test_preemption_during_ae_warmup_is_not_swallowed",
    "tests/test_runner.py::test_cli_profile_and_debug_nans_flags",
    "tests/test_runner.py::test_evaluate_with_device_mesh_matches_single_device",
    "tests/test_ensemble.py::test_mesh_ensemble_matches_single_device",
    "tests/test_ensemble.py::test_fit_mesh_multi_chunk",
    "tests/test_ensemble_fourier.py::test_mesh_fourier_ensemble_matches_single_device",
    "tests/test_sr.py::test_full_sr_pipeline_on_trained_model",
    "tests/test_sr.py::test_sr_forecast_beats_zero_predictor",
    "tests/test_sr.py::test_cli_sr_forecast",
    "tests/test_train.py::test_flat_chunk_matches_pytree_step",
    # --- round-4 re-tier: everything >= ~5.5 s in the 2026-08-18 durations
    # profile moves out of the quick tier (VERDICT r3 weak #6: quick < 3 min).
    # The full suite (-m '') still runs all of these; run it before
    # committing train/parallel changes (CLAUDE.md).
    "tests/test_train.py::test_fit_resume_matches_uninterrupted",
    "tests/test_train.py::test_fit_reduces_loss_and_beats_pod",
    "tests/test_ensemble.py::test_packed_grad_matches_per_seed",
    "tests/test_ensemble.py::test_fit_selects_best_seed",
    "tests/test_ensemble.py::test_seed_state_resumes_on_single_chunk",
    "tests/test_ensemble.py::test_packed_loss_matches_per_seed",
    "tests/test_ensemble_fourier.py::test_packed_fourier_loss_matches_per_seed",
    "tests/test_runner.py::test_run_evaluate_roundtrip_device_pod",
    "tests/test_runner.py::test_run_resume",
    "tests/test_runner.py::test_run_multiseed_fourier",
    "tests/test_runner.py::test_run_multiseed_ensemble",
    "tests/test_ae.py::test_tanh_receives_no_gradient",
    "tests/test_ae.py::test_factored_ae_mse_matches_naive",
    "tests/test_fourier.py::test_period_mismatch_stall_regression",
    "tests/test_trajectory_parity.py::test_training_trajectory_matches_torch",
    "tests/test_pod.py::test_streaming_randomized_pod_matches_in_memory",
    "tests/test_parallel.py::test_chunk_output_state_stays_sharded",
    "tests/test_train.py::test_graceful_preemption_checkpoints_and_resumes_bit_exact",
    "tests/test_ae.py::test_warmup_loss_is_pure_ae_mse",
    # --- hyperparameter multi-start (>= ~5.5 s each); the quick tier keeps
    # test_resolve_hypers_grid + test_fit_hyper_sweep_selects_by_rec as the
    # cheap representatives of the grid resolution and selection semantics
    "tests/test_ensemble.py::test_hyper_loss_matches_per_seed_cfg",
    "tests/test_ensemble.py::test_hyper_trajectory_matches_single_runs",
    "tests/test_ensemble.py::test_fit_resolves_cfg_sweep_and_spans_groups",
    "tests/test_runner.py::test_run_hyper_sweep",
    "tests/test_runner.py::test_run_single_combo_sweep_is_an_override",
    "tests/test_runner.py::test_run_fourier_holdout_forecast",
    "tests/test_runner.py::test_run_desmo_holdout_forecast",
    "tests/test_runner.py::test_run_ae_holdout_forecast",
    "tests/test_runner.py::test_run_desmo_holdout_forecast_gp_engine",
    "tests/test_sr.py::test_cli_sr_ae_checkpoint_forecast",
    "tests/test_ingest_formats.py::test_cli_run_hyper_sweep_defaults_seeds_to_grid",
    # --- round-5 additions (~27 s GP run on the shipped checkpoint; ~55 s
    # 2-process multihost cluster launch)
    "tests/test_gp.py::test_gp_recovers_oscillator_structure_from_shipped_checkpoint",
    "tests/test_multihost.py::test_two_process_cluster_matches_single_process",
}


@pytest.fixture(scope="session")
def gpu_platform():
    """Skip unless a child JAX process, free of this session's CPU pin, finds
    a GPU. Decided here and never at import, so every xdist worker collects
    the same tests."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    try:
        out = subprocess.run(
            [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
            env=env, capture_output=True, text=True, timeout=300,
        )
    except subprocess.TimeoutExpired:
        pytest.skip("no GPU: probing JAX's devices timed out")
    platform = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else "none"
    if out.returncode != 0 or platform != "gpu":
        pytest.skip(f"no GPU: JAX's first device is {platform!r}")
    return env


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.nodeid.split("[")[0]
        parent = base.rsplit("::", 1)[0]
        if base in _SLOW or parent in _SLOW:
            item.add_marker(pytest.mark.slow)
