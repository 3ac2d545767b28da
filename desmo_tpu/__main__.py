"""Command-line interface: ``python -m desmo_tpu <command>``.

The reference has no CLI — each experiment is a script edited by hand and
launched via SLURM (SURVEY §2.10, §5.6). Here the five shipped configurations
are named presets:

    python -m desmo_tpu run --preset cylinder --synthetic --epochs 2000
    python -m desmo_tpu run --preset aneurysm --data-dir /data/ICA_data --array velocity --location cell
    python -m desmo_tpu presets
    python -m desmo_tpu bench
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys


def cmd_presets(_args) -> int:
    from desmo_tpu import configs

    for name in configs.names():
        cfg = configs.get(name)
        print(
            f"{name:18s} variant={cfg.variant:8s} n={cfg.n:6d} m={cfg.m:5d} "
            f"r={cfg.r} P={cfg.poly_order} epochs={cfg.num_epochs}"
        )
    return 0


def _forecast_summary(record: dict) -> dict:
    """Headline scalars of a forecast record for the one-line CLI summary —
    the per-snapshot vectors live in forecast.json / figures, and non-finite
    errors (diverged integration) become null so the line stays valid JSON
    (shared by cmd_run and cmd_evaluate)."""
    from desmo_tpu import runner

    return runner.json_finite(
        {k: v for k, v in record.items() if not k.startswith("per_snapshot")}
    )


def _parse_mesh(spec_str):
    """'space=4[,time=2]' -> a ('space','time') jax.sharding.Mesh (or None)."""
    if not spec_str:
        return None
    from desmo_tpu.parallel import make_mesh

    axes = {"space": None, "time": 1}
    for part in spec_str.split(","):
        name, _, val = part.partition("=")
        if name not in axes or not val.isdigit():
            raise SystemExit(
                f"--mesh expects 'space=<d>[,time=<d>]', got {spec_str!r}"
            )
        axes[name] = int(val)
    return make_mesh(n_space=axes["space"], n_time=axes["time"])


def cmd_run(args) -> int:
    from desmo_tpu import configs, runner, train

    # the CLI owns the process: arm SIGTERM-graceful training (SLURM
    # preemption / spot reclaim -> final checkpoint at the next chunk
    # boundary + clean exit instead of dying mid-run)
    train.install_preemption_handler()

    cfg = configs.get(args.preset)
    overrides = {}
    if args.epochs is not None:
        overrides["num_epochs"] = args.epochs
    if getattr(args, "ae_data_omega", False):
        overrides["ae_omega_data_scaled"] = True
    if getattr(args, "ae_recipe", False):
        overrides["ae_recipe"] = True
    if getattr(args, "period_multistart", None):
        overrides["period_multistart"] = args.period_multistart
    if getattr(args, "seeds", None):
        overrides["n_seeds"] = args.seeds
    if getattr(args, "seed_phi_sigma", None) is not None:
        overrides["seed_phi_sigma"] = args.seed_phi_sigma
    if getattr(args, "seed_omega_spread", None) is not None:
        overrides["seed_omega_spread"] = args.seed_omega_spread
    if getattr(args, "pod_method", None):
        overrides["pod_method"] = args.pod_method
    for flag in ("sweep_beta", "sweep_lam", "sweep_lr_scale"):
        vals = getattr(args, flag, None)
        if vals:
            parts = [s for s in vals.split(",") if s.strip()]
            try:
                overrides[flag] = tuple(float(v) for v in parts)
            except ValueError:
                print(
                    f"error: --{flag.replace('_', '-')} expects a comma-"
                    f"separated list of numbers, got {vals!r}",
                    file=sys.stderr,
                )
                return 2
    if any(k.startswith("sweep_") for k in overrides):
        # the sweep needs one packed seed per combo: default n_seeds to the
        # grid size when --seeds was NOT given (an explicit --seeds — even
        # --seeds 1 — is the user's resource choice and is respected;
        # runner.run rejects impossible combinations loudly)
        n_combo = math.prod(
            len(overrides.get(k) or (0,))
            for k in ("sweep_beta", "sweep_lam", "sweep_lr_scale")
        )
        if getattr(args, "seeds", None) is None and cfg.n_seeds <= 1 and n_combo > 1:
            overrides["n_seeds"] = n_combo
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    device_mesh = _parse_mesh(args.mesh)
    x, mesh = runner.load_data(
        cfg,
        data_dir=args.data_dir,
        filename=args.filename,
        extension=args.extension,
        array=args.array,
        location=args.location,
        t_start=args.t_start,
        t_end=args.t_end,
        npz_path=args.npz,
        synthetic=args.synthetic,
        dim=args.dim,
    )
    import contextlib

    from desmo_tpu import profiling

    if getattr(args, "debug_nans", False):
        profiling.debug_nans(True)
    trace_ctx = (
        profiling.trace(args.profile)
        if getattr(args, "profile", None)
        else contextlib.nullcontext()
    )
    out_dir = args.out_dir
    import jax

    if jax.process_count() > 1 and jax.process_index() != 0:
        # multihost: every process executes the same program; process 0's
        # artifacts are canonical, the rest land in per-process subdirs so a
        # shared filesystem sees no write collisions
        import os

        out_dir = os.path.join(out_dir, f"proc{jax.process_index()}")
    with trace_ctx:
        artifacts = runner.run(
            cfg,
            x,
            out_dir=out_dir,
            make_figures=not args.no_figures,
            mesh=mesh,
            resume_from=args.resume,
            device_mesh=device_mesh,
            holdout=getattr(args, "holdout", 0.0) or 0.0,
            holdout_engine=getattr(args, "holdout_engine", None) or "stlsq",
        )
    summary = {
        "preset": cfg.name,
        "relative_error": artifacts.relative_error,
        "pod_error_r": artifacts.pod_error_r,
        "pod_error_2r": artifacts.pod_error_2r,
        # NaN when the run fits inside the first (compile-inclusive, untimed)
        # chunk — emit null, valid JSON unlike the bare NaN literal
        "steps_per_sec": None
        if math.isnan(artifacts.steps_per_sec)
        else artifacts.steps_per_sec,
        "out_dir": artifacts.out_dir,
        "preempted": artifacts.preempted,
    }
    if artifacts.forecast is not None:
        summary["forecast"] = _forecast_summary(artifacts.forecast)
    print(json.dumps(summary))
    return 0


def cmd_bench(args) -> int:
    import os
    import runpy

    from desmo_tpu import runtime

    # absolute path: `python -m desmo_tpu bench` must work from any cwd
    bench_path = os.path.join(runtime.REPO_ROOT, "bench.py")
    sys.argv = ["bench.py"]
    runpy.run_path(bench_path, run_name="__main__")
    return 0


def cmd_evaluate(args) -> int:
    """Load a .pt checkpoint, infer, report errors + sparsification table."""
    import json as _json

    from desmo_tpu import configs, runner

    cfg = configs.get(args.preset)
    if getattr(args, "pod_method", None):
        cfg = dataclasses.replace(cfg, pod_method=args.pod_method)
    x, data_mesh = runner.load_data(
        cfg,
        data_dir=args.data_dir,
        npz_path=args.npz,
        synthetic=args.synthetic,
    )
    out = runner.evaluate(
        cfg, x, args.checkpoint,
        device_mesh=_parse_mesh(getattr(args, "mesh", None)),
        figures_dir=getattr(args, "figures", None),
        mesh=data_mesh,
        forecast_after=getattr(args, "forecast_after", None),
        forecast_engine=getattr(args, "forecast_engine", None) or "stlsq",
    )
    summary = {k: v for k, v in out.items() if k != "sweep"}
    if "forecast" in summary:
        summary["forecast"] = _forecast_summary(summary["forecast"])
    print(_json.dumps(summary))
    return 0


def cmd_sr(args) -> int:
    """DESMO-SR: load a trained checkpoint, identify dz/dt = f(z), reinject."""
    import numpy as np

    from desmo_tpu import checkpoint, configs, runner, sr
    from desmo_tpu.models import desmo as desmo_model

    cfg = configs.get(args.preset)
    x, _mesh = runner.load_data(
        cfg,
        data_dir=args.data_dir,
        npz_path=args.npz,
        synthetic=args.synthetic,
    )
    sd = checkpoint.load_pt(args.checkpoint)
    # size the model from the checkpoint (the shipped SR checkpoint is r=2,
    # P=2 on cylinder data whose training preset is r=4, P=3). AE checkpoints
    # (detected by their MLP keys) run the SAME pipeline through the frozen
    # encoder latent instead of POD modes.
    from desmo_tpu.models import autoencoder as ae_model

    is_ae = ae_model.is_ae_state_dict(sd)
    if is_ae:
        r, poly_order = ae_model.infer_spec_dims(sd)
        params = ae_model.params_from_state_dict(sd)
    else:
        r, poly_order = checkpoint.infer_spec_dims(sd)
        params = checkpoint.params_from_state_dict(sd, "desmo")
    x_future = None
    if getattr(args, "forecast", False):
        # the checkpoint was trained on the FIRST m_ckpt snapshots; the data
        # columns beyond that window are the held-out forecast targets.
        # Re-center everything on the TRAIN window's temporal mean so the
        # held-out statistics never leak into the scored reconstruction.
        m_ckpt = int(np.asarray(params["z"]).shape[1])
        if x.shape[1] <= m_ckpt:
            raise SystemExit(
                f"--forecast needs data beyond the checkpoint's training "
                f"window: checkpoint m={m_ckpt}, data m={x.shape[1]}"
            )
        mu = x[:, :m_ckpt].mean(axis=1, keepdims=True)
        x_future = np.asarray(x[:, m_ckpt:] - mu)
        x = np.asarray(x[:, :m_ckpt] - mu)
    import jax.numpy as jnp

    extra_kwargs = {}
    if is_ae:
        m_ckpt = int(np.asarray(params["z"]).shape[1])
        if x.shape[1] != m_ckpt:
            raise SystemExit(
                f"AE checkpoint encoder expects m={m_ckpt} snapshots, data "
                f"has {x.shape[1]} (use --forecast to score the columns "
                "beyond the training window)"
            )
        spec = ae_model.AESpec(x.shape[0], x.shape[1], r, poly_order, cfg.omega_init)
        # no POD: the dictionary lives on the FROZEN encoder latent, and
        # channel selection uses the latent-override term energies
        from desmo_tpu import sparsify

        latent, recon_fn = ae_model.frozen_latent_recon(params, jnp.asarray(x), spec)
        # mask_inactive_trig: tanh is masked out of the AE recon, so its
        # untrained init-ones energies must not pass channel selection
        energies = sparsify.mask_inactive_trig(
            sparsify.term_energies(params, latent_override=latent, spec=spec),
            spec,
        )
        extra_kwargs = dict(
            channels=sr.active_channels(energies, args.energy_threshold),
            recon_fn=recon_fn,
        )
        batch = {"x": jnp.asarray(x)}
    else:
        spec = desmo_model.DesmoSpec(x.shape[0], x.shape[1], r, poly_order, cfg.omega_init)
        # POD must be rebuilt EXACTLY as training built it — same method (sign
        # convention) AND same construction (compute_pod factorizes at rank 2r
        # then truncates; for 'randomized' a direct rank-r sketch would be a
        # DIFFERENT random subspace, not just different signs). Default 'host' =
        # the reference's np.linalg.svd (all imported .pt checkpoints); a
        # checkpoint from `run --pod-method X` analyzes with `sr --pod-method X`.
        cfg_pod = dataclasses.replace(
            cfg, n=x.shape[0], m=x.shape[1], r=r, poly_order=poly_order,
            pod_method=getattr(args, "pod_method", None) or "host",
        )
        p, _p2 = runner.compute_pod(cfg_pod, x)
        batch = {"x": jnp.asarray(x), "pod_modes": p.modes}
    sr_kwargs = dict(
        energy_threshold=args.energy_threshold,
        degree=args.degree,
        engine=args.engine,
        **extra_kwargs,
        gp_kwargs=(
            {"niterations": args.gp_iters}
            if getattr(args, "gp_iters", None) is not None
            else None
        ),
        log=print,
    )
    fig_dir = getattr(args, "figures", None)
    if fig_dir is not None:
        import os

        from desmo_tpu import viz
    if x_future is not None:
        rec = sr.forecast(
            params, batch, spec, x_future,
            stabilize=getattr(args, "stabilize", False), **sr_kwargs,
        )
        if fig_dir is not None:
            viz.sr_trajectories(
                rec["z_data"],
                np.concatenate([rec["z_sim"], rec["z_future"]]),
                sr.channel_names(rec["channels"], spec),
                os.path.join(fig_dir, "sr_trajectories.png"),
                m_train=rec["m_train"],
            )
            viz.forecast_errors(
                rec["per_snapshot_train_error"],
                rec["per_snapshot_error"],
                os.path.join(fig_dir, "forecast.png"),
            )
        print(f"channels: {rec['channels']}")
        print(json.dumps(runner.json_finite(
            {k: v for k, v in rec.items() if not isinstance(v, np.ndarray)}
        )))
        return 0
    result = sr.identify_and_reinject(params, batch, spec, **sr_kwargs)
    if fig_dir is not None:
        # the reference's DynSysFit comparison figure (trained z solid,
        # discovered dashed, DESMO-SR/...py:1306-1327)
        viz.sr_trajectories(
            result.z_data, result.z_sim,
            sr.channel_names(result.channels, spec),
            os.path.join(fig_dir, "sr_trajectories.png"),
        )
    print(f"channels: {result.channels}")
    return 0


def cmd_pod(args) -> int:
    """Standalone POD analysis — the reference's ``POD_analysis`` stage
    (``CYL:197-299``) as its own command, including the out-of-core streaming
    path for snapshot series larger than host RAM (pod.streaming_randomized_pod)."""
    import numpy as np

    from desmo_tpu import configs, pod, runner

    cfg = configs.get(args.preset)
    r = args.rank if args.rank is not None else cfg.r
    if args.method == "streaming":
        if not args.data_dir:
            raise SystemExit("--method streaming requires --data-dir (on-disk series)")
        from desmo_tpu import data as data_mod
        from desmo_tpu.io import vtk as vio

        stop = (
            args.t_end
            if args.t_end is not None
            else args.t_start + cfg.m * cfg.time_stride
        )

        def raw_blocks():
            return vio.iter_snapshot_column_blocks(
                args.data_dir, args.filename, args.t_start, stop,
                extension=args.extension, array=args.array,
                location=args.location, block=args.block,
            )

        blocks, m, _mean = data_mod.streaming_preprocess_blocks(
            raw_blocks,
            dim=args.dim if args.dim is not None else cfg.dim,
            time_stride=cfg.time_stride,
            inv_sqrt_m=cfg.scale_inv_sqrt_m,
        )
        res = pod.canonical_signs(
            pod.streaming_randomized_pod(
                blocks, m, r, oversample=args.oversample, n_iter=args.iters
            )
        )
        # exact within the captured subspace: ||X - QQ^T X|| via the energy tail
        err = float(np.sqrt(max(0.0, 1.0 - float(np.sum(np.asarray(res.energy)[:r])))))
        data_mesh = None  # streamed column blocks never materialize the mesh
    else:
        x, data_mesh = runner.load_data(
            cfg,
            data_dir=args.data_dir,
            filename=args.filename,
            extension=args.extension,
            array=args.array,
            location=args.location,
            t_start=args.t_start,
            t_end=args.t_end,
            npz_path=args.npz,
            synthetic=args.synthetic,
            dim=args.dim,
        )
        if args.method == "host":
            res = pod.pod_host(x, r)
        else:
            res = pod.canonical_signs(
                pod.pod(
                    x, r, method=args.method,
                    oversample=args.oversample, n_iter=args.iters,
                    mesh=_parse_mesh(getattr(args, "mesh", None)),
                )
            )
        err = pod.pod_relative_error(x, res)
    if getattr(args, "figures", None):
        # the reference POD_analysis reports (CYL:214-236: singular values,
        # cumulative energy, temporal coefficients) + the spatial mode panels
        # (CYL:241-276, PyVista there; scatter/voxel fallback here)
        import os

        from desmo_tpu import viz

        modes = np.asarray(res.modes)
        points, grid_shape, plane = viz.field_layout(data_mesh, modes.shape[0])
        viz.pod_spectrum(
            np.asarray(res.singular_values),
            os.path.join(args.figures, "pod_spectrum.png"),
        )
        viz.temporal_coefficients(
            np.asarray(res.temporal),
            os.path.join(args.figures, "temporal.png"),
            labels=[str(i + 1) for i in range(r)],
        )
        viz.mode_fields(
            modes, None, os.path.join(args.figures, "modes.png"),
            points=points, grid_shape=grid_shape, plane=plane,
        )
    if args.save:
        np.savez(
            args.save,
            modes=np.asarray(res.modes),
            temporal=np.asarray(res.temporal),
            singular_values=np.asarray(res.singular_values),
            energy=np.asarray(res.energy),
        )
    print(
        json.dumps(
            {
                "preset": cfg.name,
                "method": args.method,
                "rank": r,
                "relative_error": err,
                "singular_values": np.asarray(res.singular_values).tolist(),
                "energy_captured": float(np.sum(np.asarray(res.energy)[:r])),
                "saved": args.save,
            }
        )
    )
    return 0


def cmd_import_pt(args) -> int:
    """Inspect / convert a PyTorch checkpoint (reference or ours)."""
    from desmo_tpu import checkpoint

    sd = checkpoint.load_pt(args.path)
    for k in sorted(sd):
        print(f"{k:32s} {tuple(sd[k].shape)}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="desmo_tpu", description=__doc__)
    # backend flags shared by every subcommand that touches JAX: pick the
    # platform (JAX_PLATFORMS works too) and the virtual CPU device count
    backend = argparse.ArgumentParser(add_help=False)
    backend.add_argument(
        "--platform", default=None, help="force a JAX platform (e.g. cpu)"
    )
    backend.add_argument(
        "--cpu-devices", type=int, default=None,
        help="number of virtual CPU devices (for mesh runs without GPUs)",
    )
    backend.add_argument(
        "--figure-format", default=None, choices=["png", "pdf", "svg"],
        help="on-disk format for every rendered figure (default png; pdf "
        "mirrors the reference's save_graphic PDFs, CYL:849)",
    )
    # multi-host (multi-process) cluster entry — SURVEY §5.8. Launch the
    # SAME command on every host; --mesh then spans the global device set
    # and XLA carries the sharded chunk's reductions across processes. A
    # bare --multihost leaves all three values to a cluster environment that
    # jax.distributed detects (e.g. SLURM).
    backend.add_argument(
        "--multihost", nargs="?", const="", default=None, metavar="HOST:PORT",
        help="join a multi-process cluster before backend init: coordinator "
        "address (process 0's host:port), with --num-processes/--process-id; "
        "bare --multihost defers all three to the cluster environment "
        "that jax.distributed detects",
    )
    backend.add_argument(
        "--num-processes", type=int, default=None,
        help="total process count of the --multihost cluster",
    )
    backend.add_argument(
        "--process-id", type=int, default=None,
        help="this process's index in the --multihost cluster",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("presets", help="list named experiment presets")

    p_run = sub.add_parser("run", help="train a preset end to end", parents=[backend])
    p_run.add_argument("--preset", required=True)
    p_run.add_argument("--data-dir", default=None, help="directory of VTK snapshots")
    p_run.add_argument("--filename", default="velocity_", help="snapshot basename")
    p_run.add_argument("--extension", default=".vtu")
    p_run.add_argument("--array", default="velocity", help="VTK array name")
    p_run.add_argument("--location", default="point", choices=["point", "cell"])
    p_run.add_argument("--t-start", type=int, default=0)
    p_run.add_argument("--t-end", type=int, default=None)
    p_run.add_argument("--npz", default=None, help="npz file with key 'X' instead of VTK")
    p_run.add_argument("--synthetic", action="store_true", help="generate synthetic data")
    p_run.add_argument("--dim", type=int, default=None, choices=[2, 3], help="override the preset's component-dimension handling")
    p_run.add_argument("--epochs", type=int, default=None, help="override preset epochs")
    p_run.add_argument("--out-dir", default="./runs")
    p_run.add_argument("--resume", default=None, help="state_*.npz checkpoint to resume")
    p_run.add_argument("--no-figures", action="store_true")
    p_run.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="distribute training over a device mesh, e.g. 'space=4,time=2' "
        "(the sharding-aware scanned chunk: phi rows over 'space')",
    )
    p_run.add_argument(
        "--ae-recipe", action="store_true",
        help="AE variant: full convergence recipe (live MLP init, AE-only "
        "warmup, data-scaled omega; see docs/RESULTS.md)",
    )
    p_run.add_argument(
        "--ae-data-omega", action="store_true",
        help="AE variant: rescale the omega init from the initial latent RMS "
        "(convergence recipe for data whose scale differs from the preset's)",
    )
    p_run.add_argument(
        "--period-multistart", type=int, default=None, metavar="N",
        help="Fourier variants: probe up to N FFT-informed candidate periods "
        "before training and keep the best (rescues a mismatched period_init; "
        "see models/fourier.period_candidates)",
    )
    p_run.add_argument(
        "--seeds", type=int, default=None, metavar="S",
        help="desmo/fourier variants: train S independently-initialized "
        "models SIMULTANEOUSLY (packed side by side in one training step) "
        "and keep the best; with --period-multistart on a fourier preset the "
        "seeds train the FFT period candidates — see ensemble.py",
    )
    p_run.add_argument(
        "--seed-phi-sigma", type=float, default=None, metavar="SIGMA",
        help="multi-seed: relative phi init jitter for seeds > 0 (default 0.02)",
    )
    p_run.add_argument(
        "--seed-omega-spread", type=float, default=None, metavar="DECADES",
        help="multi-seed: omega init log-spread in decades for seeds > 0 "
        "(default 0 = keep the preset omega_init)",
    )
    p_run.add_argument(
        "--sweep-beta", default=None, metavar="B1,B2,...",
        help="hyperparameter multi-start: per-seed ortho weights; the "
        "cartesian product of --sweep-beta/--sweep-lam/--sweep-lr-scale "
        "forms a combo grid and packed seed s trains under combo s mod "
        "#combos in ONE packed run (--seeds defaults to the grid "
        "size). The winning seed is picked by REC error — see "
        "ensemble.resolve_hypers",
    )
    p_run.add_argument(
        "--sweep-lam", default=None, metavar="L1,L2,...",
        help="hyperparameter multi-start: per-seed L1 sparsity weights "
        "(combined with --sweep-beta/--sweep-lr-scale as a cartesian grid)",
    )
    p_run.add_argument(
        "--sweep-lr-scale", default=None, metavar="S1,S2,...",
        help="hyperparameter multi-start: per-seed LR-row scale factors "
        "(each seed's whole group-LR row is multiplied; its plateau "
        "scheduler then evolves the scaled row independently)",
    )
    p_run.add_argument(
        "--holdout", type=float, default=0.0, metavar="F",
        help="hold out the last F fraction of snapshots, train on the rest, "
        "and score an honest forecast at the HELD-OUT times (re-centered on "
        "the train mean; forecast.json + a 'forecast' summary field). "
        "Fourier variants evaluate the trained time-continuous series "
        "there; DESMO and AE chain the DESMO-SR leg (STLSQ-identified "
        "dz/dt integrated past the window; AE reconstructs through its "
        "frozen encoder latent)",
    )
    p_run.add_argument(
        "--holdout-engine", choices=("stlsq", "gp"), default="stlsq",
        help="identification engine for the chained --holdout forecast "
        "(desmo/ae variants): 'stlsq' (reference defaults) or 'gp' (the "
        "built-in genetic symbolic regression — slower, but discovers "
        "non-polynomial right-hand sides STLSQ cannot)",
    )
    p_run.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a TensorBoard-compatible jax.profiler device trace of "
        "the whole run into DIR (use a small --epochs; traces grow with "
        "steps)",
    )
    p_run.add_argument(
        "--debug-nans", action="store_true",
        help="enable jax_debug_nans: fail at the first non-finite value "
        "inside compiled code instead of at the chunk-boundary loss check "
        "(slow; for debugging diverging configs)",
    )
    p_run.add_argument(
        "--pod-method", default=None,
        choices=["host", "snapshots", "svd", "randomized"],
        help="POD initialization path (default 'host' = reference-exact "
        "np.linalg.svd signs; others run on device under a canonical sign "
        "convention — evaluate a resulting checkpoint with the SAME flag)",
    )
    sub.add_parser("bench", help="run the throughput benchmark", parents=[backend])

    p_pt = sub.add_parser("inspect-pt", help="list arrays in a .pt checkpoint")
    p_pt.add_argument("path")

    p_pod = sub.add_parser(
        "pod",
        help="standalone POD analysis (incl. out-of-core streaming over "
        "on-disk series)",
        parents=[backend],
    )
    p_pod.add_argument("--preset", required=True, help="preset supplying the preprocessing flags")
    p_pod.add_argument("--rank", "-r", type=int, default=None, help="POD rank (default: preset r)")
    p_pod.add_argument(
        "--method", default="auto",
        choices=["auto", "host", "snapshots", "svd", "randomized", "streaming"],
        help="'streaming' never materializes X (n_iter+3 passes over the "
        "files); others load X then factorize on device ('host' = reference "
        "np.linalg.svd)",
    )
    p_pod.add_argument("--data-dir", default=None, help="directory of VTK snapshots")
    p_pod.add_argument("--filename", default="velocity_")
    p_pod.add_argument("--extension", default=".vtu")
    p_pod.add_argument("--array", default="velocity")
    p_pod.add_argument("--location", default="point", choices=["point", "cell"])
    p_pod.add_argument("--t-start", type=int, default=0)
    p_pod.add_argument("--t-end", type=int, default=None)
    p_pod.add_argument("--npz", default=None)
    p_pod.add_argument("--synthetic", action="store_true")
    p_pod.add_argument("--dim", type=int, default=None, choices=[2, 3])
    p_pod.add_argument("--block", type=int, default=64, help="streaming column-block width")
    p_pod.add_argument("--oversample", type=int, default=8, help="randomized/streaming sketch oversampling")
    p_pod.add_argument("--iters", type=int, default=2, help="randomized/streaming power iterations")
    p_pod.add_argument("--save", default=None, metavar="NPZ", help="write modes/temporal/spectrum to an npz")
    p_pod.add_argument(
        "--figures", default=None, metavar="DIR",
        help="render the POD_analysis reports into DIR: singular values + "
        "cumulative energy, temporal coefficients, spatial mode panels",
    )
    p_pod.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="'randomized' only: run the factorization 'space'-sharded over "
        "a device mesh, e.g. 'space=4' (X, Q and the modes stay sharded; "
        "only k-width reductions cross devices)",
    )

    p_ev = sub.add_parser(
        "evaluate",
        help="inference + error report from a .pt checkpoint",
        parents=[backend],
    )
    p_ev.add_argument("--preset", required=True)
    p_ev.add_argument("--checkpoint", required=True)
    p_ev.add_argument("--data-dir", default=None)
    p_ev.add_argument("--npz", default=None)
    p_ev.add_argument("--synthetic", action="store_true")
    p_ev.add_argument(
        "--pod-method", default=None,
        choices=["host", "snapshots", "svd", "randomized"],
        help="rebuild POD with this method — MUST match the method the "
        "checkpoint was trained under (default 'host' = reference signs)",
    )
    p_ev.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="row-shard inference over a device mesh, e.g. 'space=4' — for "
        "spatial sizes one device can't hold (same sharding story as run)",
    )
    p_ev.add_argument(
        "--figures", default=None, metavar="DIR",
        help="render the full visual report set (modes, per-term fields, "
        "true-vs-predicted, POD spectrum, sweep, temporal coefficients) on "
        "the imported checkpoint into DIR — the reference's ReadAndInference "
        "figures",
    )
    p_ev.add_argument(
        "--forecast-after", type=int, default=None, metavar="M",
        help="beyond reference: the checkpoint was trained on the data's "
        "first M snapshots — score a forecast at the held-out times beyond "
        "M, no retraining (train-mean re-centered, no leakage). Fourier "
        "checkpoints evaluate the trained time-continuous series there; "
        "desmo/ae checkpoints chain the DESMO-SR leg (STLSQ-identified "
        "dz/dt integrated past the window, stabilized). Adds a 'forecast' "
        "record and, with --figures, the error-vs-horizon curve",
    )
    p_ev.add_argument(
        "--forecast-engine", choices=("stlsq", "gp"), default="stlsq",
        help="identification engine for the chained --forecast-after "
        "forecast on desmo/ae checkpoints (see run --holdout-engine)",
    )

    p_sr = sub.add_parser(
        "sr", help="DESMO-SR: identify dz/dt=f(z) from a checkpoint",
        parents=[backend],
    )
    p_sr.add_argument("--preset", required=True)
    p_sr.add_argument(
        "--checkpoint", required=True,
        help=".pt state_dict to analyze (desmo or AE; AE checkpoints are "
        "detected by their MLP keys and run through the frozen encoder "
        "latent — no POD rebuild)",
    )
    p_sr.add_argument("--data-dir", default=None)
    p_sr.add_argument("--npz", default=None)
    p_sr.add_argument("--synthetic", action="store_true")
    p_sr.add_argument("--energy-threshold", type=float, default=1.0)
    p_sr.add_argument("--degree", type=int, default=1)
    p_sr.add_argument(
        "--engine", choices=("stlsq", "gp", "pysr"), default="stlsq",
        help="sparse-regression engine: stlsq (SINDy), gp (built-in genetic "
        "symbolic regression, no extra deps), pysr (optional package+Julia)",
    )
    p_sr.add_argument(
        "--gp-iters", type=int, default=None,
        help="gp engine only: generations per target (default 60)",
    )
    p_sr.add_argument(
        "--pod-method", default=None,
        choices=["host", "snapshots", "svd", "randomized"],
        help="rebuild POD with this method — MUST match the method the "
        "checkpoint was trained under (default 'host' = reference signs)",
    )
    p_sr.add_argument(
        "--stabilize", action="store_true",
        help="with --forecast (stlsq degree-1): project unstable eigenvalues "
        "of the identified linear system onto the stable half-plane before "
        "integrating the forecast (stabilized-DMD-style) — a marginally "
        "unstable fit otherwise grows exponentially over a long horizon; "
        "identification reports keep the raw fit",
    )
    p_sr.add_argument(
        "--figures", default=None, metavar="DIR",
        help="render the DynSysFit comparison figure (trained z vs identified "
        "dynamics per channel) into DIR; with --forecast also the "
        "error-vs-horizon curve",
    )
    p_sr.add_argument(
        "--forecast", action="store_true",
        help="reduced-order forecasting (beyond reference): the checkpoint "
        "was trained on the FIRST m_ckpt snapshots of the given data; "
        "integrate the identified dz/dt past that window and score the "
        "reconstruction on the remaining held-out columns (train-mean "
        "re-centered, no leakage)",
    )

    args = parser.parse_args(argv)
    if args.command not in ("presets", "inspect-pt"):
        from desmo_tpu import runtime

        runtime.enable_compile_cache()
    if getattr(args, "platform", None) or getattr(args, "cpu_devices", None):
        # must land before the first backend touch
        import jax

        if args.platform:
            jax.config.update("jax_platforms", args.platform)
        if args.cpu_devices:
            jax.config.update("jax_num_cpu_devices", args.cpu_devices)
    if getattr(args, "figure_format", None):
        from desmo_tpu import viz

        viz.set_figure_format(args.figure_format)
    if getattr(args, "multihost", None) is not None:
        # must precede the first backend touch, after the platform override
        from desmo_tpu import parallel

        kw = {}
        if args.multihost:
            kw["coordinator_address"] = args.multihost
        if args.num_processes is not None:
            kw["num_processes"] = args.num_processes
        if args.process_id is not None:
            kw["process_id"] = args.process_id
        parallel.distributed_init(**kw)
    return {
        "presets": cmd_presets,
        "run": cmd_run,
        "bench": cmd_bench,
        "inspect-pt": cmd_import_pt,
        "pod": cmd_pod,
        "evaluate": cmd_evaluate,
        "sr": cmd_sr,
    }[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
