"""Benchmark: full-batch training throughput of every preset on one GPU.

    python bench.py

Runs in one process on the card and exits nonzero at once when JAX finds no
GPU. Prints ONE JSON line: the cylinder preset's steps/s as the headline
(``metric``/``value``/``unit``/``vs_baseline``), every preset under
``presets``, the packed multi-seed ensembles under ``ensemble`` /
``ensemble_fourier``, and the device it ran on (JAX's platform, device kind
and count, and ``nvidia-smi``'s name and power limit). ``vs_baseline`` divides
by the reference PyTorch run's own steps/s, derived from the checkpoint
timestamps in its shipped logs (BASELINE.md; the logs do not name the GPU).
Each timed chunk ends in ``jax.block_until_ready``; the first chunk of each
shape compiles and is not timed.
"""

import json
import time

import numpy as np

METRIC_HEADLINE = (
    "cylinder_flow full-batch optimizer steps/sec (n=3961, m=1001, r=4, P=3)"
)

# Reference steps/s per preset, from checkpoint timestamps in the shipped
# training logs (BASELINE.md). The AE script's log is not shipped -> no
# baseline; its ratio is reported as null.
BASELINES = {
    "cylinder": 28.0,
    "aneurysm": 3.5,
    "channel": 5.2,
    "fourier_cylinder": 18.0,
    "fourier_aneurysm": 3.2,
    "ae_cylinder": None,
}

# (steps per timed chunk, timed chunks) per preset
PLANS = {
    "cylinder": (2000, 7),
    "aneurysm": (500, 5),
    "channel": (800, 5),
    "fourier_cylinder": (2000, 5),
    "fourier_aneurysm": (500, 5),
    "ae_cylinder": (500, 5),
}


def _time_chunks(chunk, state, batch, steps: int, reps: int):
    """Compile + warm one chunk, then time ``reps`` chunks of ``steps``."""
    import jax

    state, metrics = chunk(state, batch, num_steps=steps)
    jax.block_until_ready((state, metrics))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, metrics = chunk(state, batch, num_steps=steps)
        jax.block_until_ready((state, metrics))
        times.append(time.perf_counter() - t0)
    return np.asarray(times), metrics


def _spread(steps: int, times: np.ndarray) -> dict:
    q1, med, q3 = np.percentile(steps / times, [25, 50, 75])
    return {"median": float(med), "iqr": [float(q1), float(q3)], "n": len(times)}


def _setup(preset: str):
    from desmo_tpu import configs, pod, runner
    from desmo_tpu.io import synthetic

    cfg = configs.get(preset)
    spec, params, loss_fn, groups = runner.build_model(cfg)
    x = synthetic.cylinder_wake(cfg.n, cfg.m, seed=0)
    modes = None if cfg.variant == "ae" else pod.pod(x, cfg.r).modes
    batch = runner.prepare_chunk_batch(cfg, x, pod_modes=modes)
    return cfg, spec, params, loss_fn, groups, batch


def bench_preset(preset: str, steps: int, reps: int) -> dict:
    """Median + IQR steps/s of the scanned training chunk."""
    import jax
    import jax.numpy as jnp

    from desmo_tpu import train

    cfg, _, params, loss_fn, groups, batch = _setup(preset)
    chunk = train.make_train_chunk(loss_fn, groups, cfg)
    state = jax.tree.map(jnp.array, train.init_state(params, cfg))
    times, metrics = _time_chunks(chunk, state, batch, steps, reps)
    if not np.isfinite(np.asarray(metrics["rec"])[-1]):
        raise FloatingPointError(f"{preset}: training diverged during benchmark")
    return _spread(steps, times)


def bench_ensemble(preset: str, steps: int, reps: int) -> dict:
    """Packed multi-seed chunk (``ensemble.make_ensemble_chunk``) at the
    largest pack width of one group, against the single-seed chunk timed in
    the same process just before it."""
    import jax
    import jax.numpy as jnp

    from desmo_tpu import ensemble

    single = bench_preset(preset, steps=steps, reps=3)["median"]
    cfg, spec, _, _, groups, batch = _setup(preset)
    S = ensemble.max_seeds_packed(spec)
    eparams = ensemble.init_params(spec, S, seed=0, phi_sigma=0.02)
    chunk = ensemble.make_ensemble_chunk(
        ensemble.build_loss(spec, cfg, S), groups, cfg, S
    )
    state = jax.tree.map(jnp.array, ensemble.init_state(eparams, cfg, S))
    times, metrics = _time_chunks(chunk, state, batch, steps, reps)
    if not np.isfinite(np.asarray(metrics["total_s"])[-1]).all():
        raise FloatingPointError(f"{preset} ensemble: training diverged")
    packed = _spread(steps, times)
    return {
        "metric": f"{preset} packed ensemble, S={S} seeds per step",
        "value": S * packed["median"],
        "unit": "seed-steps/s",
        "n_seeds": S,
        "packed_steps_per_sec": packed["median"],
        "single_seed_steps_per_sec": single,
        "cost_vs_single_x": single / packed["median"],
        "spread": packed,
    }


def main() -> None:
    from desmo_tpu import configs, flops, runtime

    runtime.enable_compile_cache()
    devices = runtime.require_gpu()
    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": runtime.gpu_name_and_power_limit(),
    }

    def entry(preset: str) -> dict:
        cfg = configs.get(preset)
        spread = bench_preset(preset, *PLANS[preset])
        useful = flops.step_flops(cfg)["useful"]
        base = BASELINES[preset]
        return {
            "metric": f"{preset} steps/sec (n={cfg.n}, m={cfg.m}, r={cfg.r}, "
            f"P={cfg.poly_order})",
            "value": spread["median"],
            "unit": "steps/s",
            "vs_baseline": spread["median"] / base if base else None,
            "spread": spread,
            "useful_gflop_per_step": useful / 1e9,
            "useful_tflop_per_s": spread["median"] * useful / 1e12,
        }

    presets = {name: entry(name) for name in PLANS}
    head = presets.pop("cylinder")
    out = {
        "metric": METRIC_HEADLINE,
        "value": head["value"],
        "unit": "steps/s",
        "vs_baseline": head["vs_baseline"],
        "spread": head["spread"],
        "device": device,
        "presets": presets,
        "ensemble": bench_ensemble("aneurysm", steps=500, reps=5),
        "ensemble_fourier": bench_ensemble("fourier_cylinder", steps=800, reps=5),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
