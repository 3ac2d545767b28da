"""End-to-end experiment runner: the framework equivalent of one reference
script's linear pipeline (read -> preprocess -> POD -> train -> sparsify ->
report; SURVEY §0), driven by a `configs.RunConfig` preset.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import numpy as np

import jax.numpy as jnp

from desmo_tpu import checkpoint, configs, data as data_mod, losses, pod, sparsify, train
from desmo_tpu.logging_utils import MetricsLogger
from desmo_tpu.models import autoencoder as ae_model
from desmo_tpu.models import desmo as desmo_model
from desmo_tpu.models import fourier as fourier_model


@dataclasses.dataclass
class RunArtifacts:
    config: configs.RunConfig
    state: train.TrainState
    history: dict
    relative_error: float
    pod_error_r: float
    pod_error_2r: float
    steps_per_sec: float
    sweep: list
    out_dir: str
    # the run was stopped early by graceful preemption (SIGTERM /
    # train.request_preemption); state_final.npz resumes it bit-exactly
    preempted: bool = False
    # temporal-holdout forecast record (fourier variant, run(holdout=f)):
    # {m_train, m_holdout, train_error, holdout_error} — None when off
    forecast: Optional[dict] = None


def load_data(
    cfg: configs.RunConfig,
    data_dir: Optional[str] = None,
    filename: str = "velocity_",
    extension: str = ".vtu",
    array: str = "velocity",
    location: str = "point",
    t_start: int = 0,
    t_end: Optional[int] = None,
    npz_path: Optional[str] = None,
    synthetic: bool = False,
    dim: Optional[int] = None,
):
    """Produce the preprocessed snapshot matrix X (n, m) from VTK series, an
    npz file (key 'X'), or the synthetic generator."""
    if dim is None:
        dim = cfg.dim
    if synthetic:
        from desmo_tpu.io import synthetic as synth

        return synth.cylinder_wake(cfg.n, cfg.m, seed=cfg.seed), None
    if npz_path is not None:
        with np.load(npz_path) as d:
            x = d["X"].astype(np.float32)
        mesh = None
    elif data_dir is not None:
        from desmo_tpu.io import native, vtk as vio

        stop = t_end if t_end is not None else t_start + cfg.m * cfg.time_stride
        x = None
        if native.available():
            try:
                x = native.read_snapshot_series_native(
                    data_dir, filename, t_start, stop,
                    extension=extension, array=array, location=location,
                )
                # mesh (geometry for viz) still comes from one Python read
                sep = "" if data_dir.endswith("/") else "/"
                mesh = vio.read_mesh(f"{data_dir}{sep}{filename}{t_start}{extension}")
            except RuntimeError:
                x = None  # unsupported sub-format: fall back to Python reader
        if x is None:
            x, mesh = vio.read_snapshot_series(
                data_dir, filename, t_start, stop,
                extension=extension, array=array, location=location,
            )
    else:
        raise ValueError("provide data_dir, npz_path, or synthetic=True")
    x, _mean = data_mod.preprocess(
        x,
        dim=dim,
        magnitude=True,
        mean_subtract=True,
        time_stride=cfg.time_stride,
        inv_sqrt_m=cfg.scale_inv_sqrt_m,
    )
    return x, mesh if data_dir is not None else None


def build_model(cfg: configs.RunConfig):
    """(spec, init_params, build_loss, param_groups) for the config's variant."""
    method = cfg.loss_method
    if cfg.variant == "fourier":
        spec = fourier_model.FourierSpec(
            cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier, cfg.period_init
        )
        params = fourier_model.init_params(spec)
        loss_fn = fourier_model.build_loss(spec, cfg.beta, cfg.l1_lambda, method=method)
        groups = fourier_model.param_groups(params)
    elif cfg.variant == "ae":
        spec = ae_model.AESpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
        params = ae_model.init_params(spec, seed=cfg.seed)
        loss_fn = ae_model.build_loss(spec, cfg.beta, cfg.l1_lambda, cfg.ae_beta, method=method)
        groups = ae_model.param_groups(params)
    else:
        spec = desmo_model.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
        params = desmo_model.init_params(spec)
        loss_fn = desmo_model.build_loss(spec, cfg.beta, cfg.l1_lambda, method=method)
        groups = desmo_model.param_groups(params)
    return spec, params, loss_fn, groups


def prepare_chunk_batch(cfg, x, pod_modes=None) -> dict:
    """The training batch of a compiled chunk, shared by ``run``,
    ``bench.py`` and ``chip_smoke.py``: X plus the X reductions the losses
    would otherwise recompute every step (``x_sq``; ``x_colsum`` for the
    factored AE-MSE, ``models/autoencoder._factored_ae_mse``)."""
    xd = jnp.asarray(x)
    batch = {"x": xd, "x_sq": jnp.sum(xd * xd)}
    if getattr(cfg, "variant", "desmo") == "ae":
        batch["x_colsum"] = jnp.sum(xd, axis=0)
    if pod_modes is not None:
        batch["pod_modes"] = jnp.asarray(pod_modes)
    return batch


def reconstruct(params: dict, batch: dict, spec, variant: str) -> jnp.ndarray:
    if variant == "fourier":
        return fourier_model.apply(params, batch["pod_modes"], spec)[0]
    if variant == "ae":
        return ae_model.apply(params, batch["x"], spec)[0]
    return desmo_model.apply(params, batch["pod_modes"], spec)[0]


def ae_recipe_cfg(cfg):
    """The --ae-recipe hyperparameter clamps, applied after the live init:
    MLP lr capped at 1e-3 (at the preset's 1e-2 the encoder collapses to
    spatially-constant latents within ~500 epochs) and the auxiliary
    reconstruction weight floored at 10 — it anchors the latents against
    the rec term's collapse-to-constant pull, and the round-5 full-length
    hyper sweep (scripts/ae_hyper_sweep.py, ae_beta x warmup grid,
    docs/RESULTS.md) measured the floor of 10 with warmup 2000 at err
    0.1216 — the POD(4)=0.1228 bracket the round-3/4 point (beta 1,
    warmup 6000, err 0.17-0.19) missed. The landscape is chaotic
    (seed/run sensitive; RESULTS.md "Seed/run robustness"): reaching the
    POD(4) class reliably takes a small sequential multi-start picking
    the best REC — each full-length AE run is ~2 min on the chip."""
    return dataclasses.replace(
        cfg, lr_z=min(cfg.lr_z, 1e-3), ae_beta=max(cfg.ae_beta, 10.0)
    )


def fourier_period_multistart(
    cfg, params, batch, loss_fn, groups, log=None, param_shardings=None,
):
    """Probe FFT-informed candidate periods (``fourier.period_candidates``)
    for ``cfg.period_probe_epochs`` each and return the best probe state by
    final rec loss; the main fit resumes from it. Beyond reference: rescues
    runs whose hard-coded ``period_init`` sits in the period no-gradient
    basin (``DESMO_Fourier/cylinder_flow/DESMO-Cylinder.py:596-600``)."""
    cands = fourier_model.period_candidates(
        np.asarray(batch["x"]),
        cfg.period_init,
        n_candidates=cfg.period_multistart,
        pod_modes=np.asarray(batch["pod_modes"]),
    )
    if not cands:
        # no usable candidate (non-positive period_init AND a DC-flat
        # spectrum) — nothing to probe; the caller proceeds from params
        if log is not None:
            log("period multi-start: no usable period candidates; skipping")
        return None
    best = None
    for pc in cands:
        p2 = dict(params)
        p2["period"] = jnp.full_like(params["period"], pc)
        p2["trig_period"] = jnp.full_like(params["trig_period"], pc)
        res = train.fit(
            loss_fn, groups, cfg, p2, batch,
            num_epochs=cfg.period_probe_epochs, log=None,
            param_shardings=param_shardings,
        )
        if res.history:
            rec = float(res.history["rec"][-1])
            if log is not None:
                log(f"period multi-start: candidate {pc:.4f} -> rec {rec:.6f}")
            if best is None or rec < best[0]:
                best = (rec, pc, res.state)
        if res.preempted:
            # fit consumed the SIGTERM latch; re-raise it so the probe loop
            # stops HERE and the main fit checkpoints and exits immediately
            # instead of training to full length after a swallowed signal
            if log is not None:
                log("period multi-start: preempted; skipping remaining candidates")
            train.request_preemption()
            break
    if best is None:
        return None
    if log is not None:
        log(f"period multi-start: keeping period {best[1]:.4f} (rec {best[0]:.6f})")
    return best[2]


def compute_pod(cfg: configs.RunConfig, x: np.ndarray, device_mesh=None):
    """Rank-r and rank-2r POD of X under ONE sign convention shared by
    run/evaluate/sr. 'host' (default) = np.linalg.svd on host, exactly the
    reference (CYL:199-205) — required whenever frozen phi masks were trained
    against reference signs (all imported .pt checkpoints). Any other
    ``cfg.pod_method`` runs on device (``pod.pod``: 'snapshots' / 'svd' /
    'randomized') wrapped in ``pod.canonical_signs``, so a checkpoint trained
    here re-derives bit-identical mode signs at evaluate time as long as the
    same method is passed — raw eigh/randomized signs are an implementation
    accident that would otherwise silently corrupt frozen-mask inference.
    ``device_mesh`` runs the 'randomized' factorization 'space'-sharded (its
    whole point is data too large for one device); the canonical signs make
    mesh and single-device runs interchangeable."""
    if cfg.pod_method == "host":
        p2 = pod.pod_host(x, 2 * cfg.r)
    else:
        p2 = pod.canonical_signs(
            # pod() routes mesh (and oversample/n_iter) to the randomized
            # path only; exact methods ignore it
            pod.pod(x, 2 * cfg.r, method=cfg.pod_method, mesh=device_mesh)
        )
    return pod.truncate(x, p2, cfg.r), p2


def run(
    cfg: configs.RunConfig,
    x: np.ndarray,
    out_dir: str = "./runs",
    num_epochs: Optional[int] = None,
    make_figures: bool = True,
    mesh=None,
    resume_from: Optional[str] = None,
    echo: bool = True,
    device_mesh=None,
    holdout: float = 0.0,
    holdout_engine: str = "stlsq",
) -> RunArtifacts:
    """Train + sparsify + report, mirroring the reference pipeline end to end.

    ``mesh`` is the VTK geometry (for figures); ``device_mesh`` is a
    ``jax.sharding.Mesh`` with a 'space' (and optionally 'time') axis — when
    given, training is distributed (SURVEY §5.7, new capability): every
    variant runs the sharding-aware scanned chunk with
    ``parallel.param_shardings`` (phi rows sharded over 'space'; XLA inserts
    the cross-device reductions). Build one with ``parallel.make_mesh`` or
    via the CLI's ``--mesh space=4,time=2``.

    ``holdout`` (all variants; beyond reference): hold out the
    LAST ``holdout`` fraction of snapshots, train on the rest, and score a
    genuine forecast at the held-out TIMES. The fourier variant evaluates
    its trained time-continuous series there directly; the desmo and ae
    variants — whose z(t) are free per-snapshot parameters with no value at
    unseen times — chain the DESMO-SR leg (``sr.forecast``: identify
    dz/dt = f(z) on the training window with STLSQ at reference defaults,
    integrate past it, reconstruct through the active channels; the ae
    variant reconstructs through its frozen encoder latent,
    ``autoencoder.frozen_latent_recon``). Both splits
    are re-centered on the TRAIN window's temporal mean so no held-out
    statistic leaks into training. The held-out error lands in
    ``RunArtifacts.forecast`` and ``forecast.json`` (with per-snapshot
    error vectors and, for desmo, the identified equations).
    ``holdout_engine`` picks the identification engine for the chained leg
    ('stlsq' default; 'gp' = the built-in genetic symbolic regression —
    slower, but discovers non-polynomial right-hand sides STLSQ cannot).
    """
    if make_figures:
        # figures render after training; a missing plotting package must
        # fail the run before it spends the training time
        try:
            from desmo_tpu import viz  # noqa: F401  (imports matplotlib)
        except ModuleNotFoundError as exc:
            raise ModuleNotFoundError(
                f"figures need the {exc.name!r} package: install it or pass "
                "make_figures=False (CLI: --no-figures)",
                name=exc.name,
            ) from exc
    x_hold = None
    if holdout:
        if cfg.variant not in ("fourier", "desmo", "ae"):
            raise ValueError(
                "holdout forecasting needs the fourier variant (scores the "
                "time-continuous series at held-out times) or the desmo/ae "
                f"variants (identified-dynamics forecast) — got {cfg.variant!r}"
            )
        if not 0.0 < holdout < 0.5:
            raise ValueError(f"holdout must be in (0, 0.5), got {holdout}")
        m_train = int(round(x.shape[1] * (1.0 - holdout)))
        if m_train < 8 or m_train >= x.shape[1]:
            raise ValueError(
                f"holdout {holdout} leaves m_train={m_train} of {x.shape[1]}"
            )
        mu_train = x[:, :m_train].mean(axis=1, keepdims=True)
        x_hold = np.asarray(x[:, m_train:] - mu_train)
        x = np.asarray(x[:, :m_train] - mu_train)
    cfg = dataclasses.replace(cfg, n=x.shape[0], m=x.shape[1])
    if cfg.n_seeds <= 1:
        from desmo_tpu import ensemble as _ens

        # sweep lists without seeds, resolved BEFORE build_model bakes
        # beta/lambda into the loss: a multi-combo grid is a config error
        # (it needs one packed seed per combo); a SINGLE non-default combo
        # is just an override — apply it directly so `--sweep-beta 5e-4`
        # alone works instead of being silently ignored on the single-seed
        # path. (Sweep lists AT the cfg defaults resolve to None = no sweep.)
        hyp1 = _ens.resolve_hypers(cfg, 1, warn=False)
        if hyp1 is not None and len(hyp1["combos"]) > 1:
            raise ValueError(
                "a hyperparameter sweep (sweep_beta/sweep_lam/sweep_lr_scale "
                "with more than one combo) needs n_seeds > 1 — pass --seeds, "
                "or omit it and the CLI defaults n_seeds to the combo-grid "
                "size"
            )
        if hyp1 is not None:
            b1, lm1, sc1 = hyp1["combos"][0]
            cfg = dataclasses.replace(
                cfg, beta=b1, l1_lambda=lm1,
                lr_coef=cfg.lr_coef * sc1, lr_phi=cfg.lr_phi * sc1,
                lr_z=cfg.lr_z * sc1, lr_omega=cfg.lr_omega * sc1,
                lr_period=cfg.lr_period * sc1,
                sweep_beta=(), sweep_lam=(), sweep_lr_scale=(),
            )
    out_dir = os.path.join(out_dir, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    spec, params, loss_fn, groups = build_model(cfg)
    if cfg.variant == "ae" and cfg.ae_omega_data_scaled:
        params = dict(params)
        params["omega"] = ae_model.data_scaled_omega(params, jnp.asarray(x))

    p, p2 = compute_pod(cfg, x, device_mesh=device_mesh)

    batch = prepare_chunk_batch(
        cfg, x, pod_modes=None if cfg.variant == "ae" else p.modes
    )
    xd = batch["x"]
    param_shardings = None
    if device_mesh is not None:
        from desmo_tpu import parallel

        if cfg.n_seeds <= 1:
            # multi-start composes with the mesh through ensemble.fit's own
            # sharding-aware packed chunk
            param_shardings = parallel.param_shardings(params, device_mesh, cfg.m)
        batch = parallel.shard_batch(batch, device_mesh)

    state = None
    if resume_from:
        template = train.init_state(params, cfg)
        state = checkpoint.load_state(resume_from, template)

    # fit() already echoes the reference-format epoch lines; the logger only
    # persists CSV/JSONL (echo would duplicate every line)
    logger = MetricsLogger(out_dir, cfg.name, echo=False)

    def ckpt(state, epoch):
        checkpoint.save_state(os.path.join(out_dir, f"state_epoch{epoch}.npz"), state)
        checkpoint.save_pt(
            os.path.join(out_dir, f"{cfg.name}_r{cfg.r}_epoch{epoch}.pt"),
            _to_state_dict(state.params, cfg.variant),
        )

    def log_line(line):
        print(line, flush=True)

    import contextlib

    mesh_ctx = device_mesh if device_mesh is not None else contextlib.nullcontext()

    if cfg.variant == "ae" and cfg.ae_recipe and state is None:
        # Full AE convergence recipe (docs/RESULTS.md "AE convergence"):
        # 1. live MLP init — the reference's Xavier/zero-bias funnel has an
        #    exactly-dead decoder (zero gradient on every MLP weight);
        # 2. MLP lr capped at 1e-3 — at the preset's 1e-2 the encoder
        #    collapses to spatially-constant latents within ~500 epochs;
        # 3. AE-only warmup so the latent bottleneck is informative before
        #    the dictionary objective joins;
        # 4. data-scaled omega from the warmed latents, lr_omega scaled to
        #    keep the reference's 1% relative omega step.
        params = ae_model.init_params_live(spec, seed=cfg.seed)
        cfg = ae_recipe_cfg(cfg)
        loss_fn = ae_model.build_loss(
            spec, cfg.beta, cfg.l1_lambda, cfg.ae_beta, method=cfg.loss_method
        )
        if cfg.ae_warmup_epochs > 0:
            # the warmup respects a requested device mesh like the main
            # phase (same sharding-aware scanned chunk)
            with mesh_ctx:
                warm = train.fit(
                    ae_model.build_warmup_loss(spec),
                    groups,
                    cfg,
                    params,
                    batch,
                    num_epochs=cfg.ae_warmup_epochs,
                    log=log_line if echo else None,
                    param_shardings=param_shardings,
                )
            params = dict(warm.state.params)
            if warm.preempted:
                # the warmup consumed the SIGTERM latch; re-raise it so the
                # main fit saves the warmed state and exits immediately
                train.request_preemption()
        om = ae_model.data_scaled_omega(params, xd)
        params["omega"] = om
        cfg = dataclasses.replace(
            cfg, lr_omega=0.01 * float(jnp.mean(jnp.abs(om[0])))
        )

    # n_seeds > 1 subsumes the sequential period probe: ensemble.fit assigns
    # the FFT-informed candidates as per-seed period inits instead
    if (
        cfg.variant == "fourier" and cfg.period_multistart > 1
        and state is None and cfg.n_seeds <= 1
    ):
        with mesh_ctx:
            state = fourier_period_multistart(
                cfg, params, batch, loss_fn, groups,
                log=log_line if echo else None,
                param_shardings=param_shardings,
            )

    n_epochs = num_epochs if num_epochs is not None else cfg.num_epochs

    stab = None  # cross-seed term-stability report (multi-seed runs only)
    seed_rec_fig = None  # (labels, recs, best) for viz.seed_recs
    if cfg.n_seeds > 1:
        if cfg.variant not in ("desmo", "fourier") or state is not None:
            raise ValueError(
                "n_seeds > 1 requires the desmo or fourier variant and no "
                "--resume (ensemble.py scope)"
            )
        # Packed multi-seed training (ensemble.py, beyond reference): S
        # models trained simultaneously in one packed step, best kept.
        from desmo_tpu import ensemble

        if cfg.loss_method != "factored" and echo:
            print(
                f"[ensemble] loss_method={cfg.loss_method!r} has no packed "
                "form; using the factored loss"
            )
        ens_report: dict = {}
        with mesh_ctx:
            result, best_seed, finals = ensemble.fit(
                cfg, spec, batch, n_seeds=cfg.n_seeds, num_epochs=n_epochs,
                seed=cfg.seed, phi_sigma=cfg.seed_phi_sigma,
                omega_spread=cfg.seed_omega_spread,
                log=log_line if echo else None,
                checkpoint_fn=ckpt,
                device_mesh=device_mesh,
                report=ens_report,
            )
        if echo:
            rate = (
                f"; {result.steps_per_sec:.1f} seed-steps/s"
                if np.isfinite(result.steps_per_sec)
                else ""  # single-chunk runs have no post-compile timing
            )
            print(
                f"[ensemble] kept seed {best_seed}/{cfg.n_seeds} "
                f"(finals: {finals}){rate}"
            )
        # persist the multi-start outcome (init-sensitivity record): which
        # seed won and every member's final total
        with open(os.path.join(out_dir, "ensemble.json"), "w") as fh:
            json.dump(
                {
                    "n_seeds": int(cfg.n_seeds),
                    "best_seed": int(best_seed),
                    # diverged (frozen) seeds report inf — not valid JSON,
                    # record them as null plus an explicit index list
                    "final_totals": [
                        float(v) if np.isfinite(v) else None for v in finals
                    ],
                    # per-seed final REC: the cross-seed comparable numbers
                    # (totals are not comparable under a hyper sweep)
                    "final_recs": [
                        float(v) if np.isfinite(v) else None
                        for v in ens_report.get("final_recs", [])
                    ],
                    "diverged_seeds": [
                        int(i) for i in np.nonzero(~np.isfinite(finals))[0]
                    ],
                    "seed_steps_per_sec": (
                        float(result.steps_per_sec)
                        if np.isfinite(result.steps_per_sec)
                        else None
                    ),
                    "seed_phi_sigma": float(cfg.seed_phi_sigma),
                    "seed_omega_spread": float(cfg.seed_omega_spread),
                    # hyperparameter multi-start record (None when off):
                    # which (beta, l1_lambda, lr_scale) each seed trained
                    # under, so the winning setting is reproducible — from
                    # fit's report, i.e. the hypers it ACTUALLY used
                    "hypers": (
                        None
                        if (hyp := ens_report.get("hypers")) is None
                        else {
                            "combos": [list(c) for c in hyp["combos"]],
                            "betas": hyp["betas"].tolist(),
                            "lams": hyp["lams"].tolist(),
                            "lr_scales": hyp["lr_scales"].tolist(),
                            "best_combo": [
                                float(hyp["betas"][best_seed]),
                                float(hyp["lams"][best_seed]),
                                float(hyp["lr_scales"][best_seed]),
                            ],
                        }
                    ),
                },
                fh,
                indent=1,
            )
        recs_list = list(ens_report.get("final_recs", []))
        if len(recs_list) >= 2:
            # per-member outcome chart: REC per seed (labeled with the hyper
            # combo under a sweep), winner marked — viz.seed_recs
            if (hyp := ens_report.get("hypers")) is not None:
                labels = []
                for s in range(len(recs_list)):
                    lbl = (
                        f"seed {s}: beta={float(hyp['betas'][s]):g} "
                        f"lam={float(hyp['lams'][s]):g}"
                    )
                    if float(hyp["lr_scales"][s]) != 1.0:
                        lbl += f" lr x{float(hyp['lr_scales'][s]):g}"
                    labels.append(lbl)
            else:
                labels = [f"seed {s}" for s in range(len(recs_list))]
            seed_rec_fig = (labels, recs_list, int(best_seed))
        live_params = ens_report.get("seed_params", [])
        live_idx = list(ens_report.get("live_seeds", []))
        hyper_group = None
        if (hyp := ens_report.get("hypers")) is not None and live_params:
            # Under a hyper sweep the seeds train with DIFFERENT (beta,
            # l1_lambda): selection differences across those members measure
            # regularization strength, not init sensitivity. Restrict the
            # stability report to live seeds sharing the winning seed's
            # objective (lr_scale only changes optimization, so it stays
            # pooled); the JSON records which group the frequencies are over.
            bw = float(hyp["betas"][best_seed])
            lw = float(hyp["lams"][best_seed])
            keep = [
                k for k, i in enumerate(live_idx)
                if float(hyp["betas"][i]) == bw and float(hyp["lams"][i]) == lw
            ]
            live_params = [live_params[k] for k in keep]
            live_idx = [live_idx[k] for k in keep]
            hyper_group = {"beta": bw, "l1_lambda": lw}
        if len(live_params) >= 2:
            # TERM-STABILITY report (beyond reference): selection frequency
            # of every candidate term across the live multi-start members at
            # the reference's energy-threshold convention — frequency 1.0 =
            # robust structure, fractional = init-sensitive artifact
            stab = ensemble.term_stability(live_params, spec)
            with open(os.path.join(out_dir, "term_stability.json"), "w") as fh:
                json.dump(
                    {
                        "threshold": stab["threshold"],
                        "live_seeds": live_idx,
                        "hyper_group": hyper_group,
                        "names": stab["names"],
                        "frequency": stab["frequency"].tolist(),
                        "energy_mean": stab["mean"].tolist(),
                        "energy_std": stab["std"].tolist(),
                    },
                    fh,
                    indent=1,
                )
            if echo:
                grp = (
                    f" (winning hyper group beta={hyper_group['beta']:g}, "
                    f"lambda={hyper_group['l1_lambda']:g})"
                    if hyper_group is not None
                    else ""
                )
                unstable = [
                    (n, f)
                    for n, f in zip(stab["names"], stab["frequency"])
                    if 0.0 < f < 1.0
                ]
                if unstable:
                    print(
                        "[ensemble] init-sensitive terms (selection "
                        f"frequency < 1 at threshold {stab['threshold']:g}"
                        f"{grp}): "
                        + ", ".join(f"{n}={f:.2f}" for n, f in unstable)
                    )
                else:
                    print(
                        "[ensemble] term selection is stable across all "
                        f"{len(live_idx)} seeds "
                        f"(threshold {stab['threshold']:g}{grp})"
                    )
        ckpt(result.state, int(result.state.epoch))
    else:
        with mesh_ctx:
            result = train.fit(
                loss_fn,
                groups,
                cfg,
                params,
                batch,
                num_epochs=n_epochs,
                log=log_line if echo else None,
                checkpoint_fn=ckpt,
                state=state,
                param_shardings=param_shardings,
            )
    # a preempted run has history only for the epochs it completed
    n_ran = (
        len(next(iter(result.history.values()))) if result.history else 0
    )
    start_epoch = int(result.state.epoch) - n_ran
    for i in range(0, n_ran, cfg.log_every):
        logger.log_epoch(
            start_epoch + i, start_epoch + n_epochs,
            {k: v[i] for k, v in result.history.items()},
        )
    logger.close()

    recon = reconstruct(result.state.params, batch, spec, cfg.variant)
    err = float(losses.relative_frobenius_error(xd, recon))
    err_pod = pod.pod_relative_error(x, p)
    err_pod2 = pod.pod_relative_error(x, p2)
    if echo:
        # same comparison block as CYL:1029-1040
        print(f"DESMO error with {cfg.r} modes: {err}")
        print(f"POD error with {cfg.r} modes: {err_pod}")
        print(f"POD error with {2 * cfg.r} modes: {err_pod2}")

    forecast = None
    if getattr(result, "preempted", False):
        # SIGTERM grace windows are short: write the resumable artifacts NOW
        # and skip everything else — holdout scoring, sweeps, greedy and
        # figure reports all cost device round trips a SIGKILL can preempt
        # (run `evaluate` on the .pt offline instead)
        final_pt = os.path.join(out_dir, f"{cfg.name}_r{cfg.r}_final.pt")
        checkpoint.save_pt(final_pt, _to_state_dict(result.state.params, cfg.variant))
        checkpoint.save_state(os.path.join(out_dir, "state_final.npz"), result.state)
        return RunArtifacts(
            config=cfg,
            state=result.state,
            history=result.history,
            relative_error=err,
            pod_error_r=err_pod,
            pod_error_2r=err_pod2,
            steps_per_sec=result.steps_per_sec,
            sweep=[],
            out_dir=out_dir,
            preempted=True,
            forecast=None,
        )

    if x_hold is not None:
        try:
            if cfg.variant == "fourier":
                forecast = _fourier_forecast_record(
                    result.state.params, batch["pod_modes"], spec, cfg.m,
                    xd, recon, err, x_hold,
                )
            else:
                # desmo/ae: the trained z(t) cannot extrapolate — chain the
                # DESMO-SR leg in-run (_chained_forecast_record)
                forecast = _chained_forecast_record(
                    cfg, spec, checkpoint.device_fetch_tree(result.state.params),
                    x, batch.get("pod_modes"), err, x_hold,
                    log=print if echo else None, engine=holdout_engine,
                )
        except Exception as exc:
            # The identify/integrate legs can legitimately fail (no channel
            # above the selection threshold, RK45 step collapse on a
            # diverging identified system). A failed forecast must NOT
            # discard the training run's final checkpoint/sweep/figures —
            # same invariant as the preemption path above: artifact writes
            # beat fragile post-processing.
            forecast = {
                "m_train": int(cfg.m),
                "m_holdout": int(x_hold.shape[1]),
                "train_error": err,
                "error": f"{type(exc).__name__}: {exc}",
            }
        with open(os.path.join(out_dir, "forecast.json"), "w") as fh:
            json.dump(json_finite(forecast), fh, indent=1)
        if echo:
            if "error" in forecast:
                print(
                    "forecast FAILED (final artifacts still saved): "
                    f"{forecast['error']}"
                )
            else:
                how = (
                    "trained series at held-out times"
                    if cfg.variant == "fourier"
                    else "identified dynamics integrated past the window"
                )
                print(
                    f"forecast ({how}): trained on {cfg.m} snapshots, held out "
                    f"{forecast['m_holdout']}; train err {err:.6f}, HELD-OUT err "
                    f"{forecast['holdout_error']:.6f} "
                    "(POD alone cannot forecast unseen times at all)"
                )

    sweep = sparsify.threshold_sweep(
        result.state.params,
        batch,
        spec,
        variant=cfg.variant,
        log=print if echo else None,
    )
    if cfg.run_greedy_prune:
        # the turbulent-channel reference additionally runs greedy one-at-a-
        # time term removal (...TurbulentChannel.py:1166-1245)
        sparsify.greedy_prune(
            result.state.params, batch, spec, variant=cfg.variant,
            log=print if echo else None,
        )

    if make_figures:
        _figure_reports(
            os.path.join(out_dir, "figures"), cfg, spec,
            result.state.params, x, xd, recon, batch, p, p2, sweep,
            mesh=mesh, history=result.history, forecast=forecast, stab=stab,
            seed_rec_fig=seed_rec_fig,
        )

    final_pt = os.path.join(out_dir, f"{cfg.name}_r{cfg.r}_final.pt")
    checkpoint.save_pt(final_pt, _to_state_dict(result.state.params, cfg.variant))
    checkpoint.save_state(os.path.join(out_dir, "state_final.npz"), result.state)

    return RunArtifacts(
        config=cfg,
        state=result.state,
        history=result.history,
        relative_error=err,
        pod_error_r=err_pod,
        pod_error_2r=err_pod2,
        steps_per_sec=result.steps_per_sec,
        sweep=sweep,
        out_dir=out_dir,
        preempted=getattr(result, "preempted", False),
        forecast=forecast,
    )


def json_finite(obj):
    """Replace non-finite floats with ``None``, recursively — the one
    serialization-boundary guard for forecast records, whose errors come from
    integrated trajectories and can legitimately be inf/nan (a diverged
    identified system). ``json.dump`` would emit the literals
    ``Infinity``/``NaN``, invalid per RFC 8259 and rejected by jq; same
    convention as ensemble.json's null-for-diverged finals and the CLI's
    null ``steps_per_sec``. In-memory records stay raw (figures difference
    real float vectors); sanitize only at dump/print sites."""
    if isinstance(obj, dict):
        return {k: json_finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _to_state_dict(params: dict, variant: str) -> dict:
    # one packed host fetch up front instead of one copy per key inside
    # state_dict_from_params
    params = checkpoint.device_fetch_tree(params)
    if variant == "ae":
        return ae_model.state_dict_from_params(params)
    return checkpoint.state_dict_from_params(params, variant)


def _fourier_forecast_record(
    params: dict,
    pod_modes,
    spec,
    m_train: int,
    xd,
    recon,
    err: float,
    x_hold: np.ndarray,
) -> dict:
    """Score a trained fourier series at the held-out times — shared by
    ``run(holdout=...)`` and ``evaluate(forecast_after=...)``.

    The train grid is ``t_points(m_train) = linspace(0, m_train, m_train)``
    (reference convention, spacing m/(m-1)), so physical snapshot j sits at
    ``t = j * m_train/(m_train - 1)`` — held-out j = m_train..m-1 continue
    that axis exactly. Per-snapshot error vectors for both windows make
    horizon-dependent growth visible (and feed ``viz.forecast_errors``);
    the scalars stay the headline metrics."""
    h = int(np.asarray(x_hold).shape[1])
    t_hold = (float(m_train) / (m_train - 1)) * np.arange(
        m_train, m_train + h, dtype=np.float32
    )
    recon_h, _, _ = fourier_model.apply(
        params, pod_modes, spec, t=jnp.asarray(t_hold)
    )
    err_hold = float(
        losses.relative_frobenius_error(jnp.asarray(x_hold), recon_h)
    )
    per_train = np.asarray(losses.per_snapshot_relative_error(xd, recon))
    per_hold = np.asarray(
        losses.per_snapshot_relative_error(jnp.asarray(x_hold), recon_h)
    )
    return {
        "m_train": int(m_train),
        "m_holdout": h,
        "train_error": err,
        "holdout_error": err_hold,
        **_forecast_baselines(np.asarray(xd), np.asarray(x_hold)),
        "per_snapshot_train_error": per_train.tolist(),
        "per_snapshot_holdout_error": per_hold.tolist(),
    }


def _forecast_baselines(x_train: np.ndarray, x_hold: np.ndarray) -> dict:
    """Trivial-predictor errors on the holdout window, for margin asserts.

    ``baseline_zero_error`` is the zero predictor == the train-mean
    predictor (the pipeline re-centers both windows on the TRAIN mean, so
    the mean snapshot is exactly zero): relative Frobenius error is 1.0 by
    construction, recorded as a computed value anyway so a future centering
    change can't silently invalidate the tests' margins.
    ``baseline_last_error`` persists the final training snapshot across the
    holdout window — the standard persistence forecast, the weakest
    non-degenerate comparator (the reference reports only in-window SR
    re-infer error, DESMO-SR/...DynamicalSystemsFit.py:1381)."""
    nrm = float(np.linalg.norm(x_hold))
    last = x_train[:, -1:]
    return {
        "baseline_zero_error": float(np.linalg.norm(x_hold) / nrm),
        "baseline_last_error": float(
            np.linalg.norm(np.broadcast_to(last, x_hold.shape) - x_hold) / nrm
        ),
    }


def _chained_forecast_record(
    cfg,
    spec,
    params_host: dict,
    x,
    pod_modes,
    err: float,
    x_hold: np.ndarray,
    log=None,
    engine: str = "stlsq",
    gp_kwargs: Optional[dict] = None,
) -> dict:
    """Identified-dynamics forecast for the desmo/ae variants — shared by
    ``run(holdout=...)`` and ``evaluate(forecast_after=...)``.

    The trained z(t) are free per-snapshot parameters with no value at
    unseen times, so the chain runs the DESMO-SR leg: STLSQ-identify
    dz/dt = f(z) on the training window, integrate past it, reconstruct
    through the active channels (``sr.forecast``, stabilized). The
    identified system is capped at the 3r highest-energy channels
    (``sr.top_channels``): rich models pass dozens of threshold-survivors
    whose fitted system is unstable under integration. The AE variant
    reconstructs through its FROZEN encoder latent
    (``autoencoder.frozen_latent_recon``)."""
    from desmo_tpu import sr as sr_mod

    sr_batch = {"x": jnp.asarray(x)}
    if pod_modes is not None:
        sr_batch["pod_modes"] = pod_modes
    recon_fn = None
    latent_override = None
    if cfg.variant == "ae":
        latent_override, recon_fn = ae_model.frozen_latent_recon(
            params_host, sr_batch["x"], spec
        )
    # Variant-aware channel cap: 3r for desmo (the reference's SR leg works
    # on 5 of 12 channels at r=2), but 5r for the AE — its dictionary terms
    # share ONE learned latent, so they are strongly correlated and the fit
    # spreads signed, partially-canceling energy across nearly all of them;
    # at the 3r cap the zeroed-inactive forecaster loses MORE than the whole
    # signal (measured train-window truncation err 1.21 at cap 3r vs 0.25 at
    # 5r, holdout 1.07 -> 0.36 — docs/RESULTS.md "chained-forecast quality
    # bars", round 5). 5r keeps every non-tanh channel at the reference's
    # r=2/P=2 shape while still bounding rich models.
    cap = (5 if cfg.variant == "ae" else 3) * spec.r
    channels = sr_mod.top_channels(
        # mask_inactive_trig: the AE forward masks tanh out of the recon, so
        # its untrained init-ones energies must not crowd real channels out
        # of the cap (they'd be constant all-ones columns in STLSQ)
        sparsify.mask_inactive_trig(
            sparsify.term_energies(
                params_host, latent_override=latent_override, spec=spec
            ),
            spec,
        ),
        max_channels=cap,
    )
    rec = sr_mod.forecast(
        params_host, sr_batch, spec, x_hold,
        channels=channels, stabilize=True, recon_fn=recon_fn, log=log,
        engine=engine, gp_kwargs=gp_kwargs,
    )
    return {
        "m_train": int(cfg.m),
        "m_holdout": int(x_hold.shape[1]),
        "train_error": err,
        "holdout_error": rec["error_forecast"],
        **_forecast_baselines(np.asarray(x), np.asarray(x_hold)),
        "engine": engine,
        "stabilized": rec["stabilized"],
        "error_train_simulated": rec["error_train_simulated"],
        "channels": [list(c) for c in rec["channels"]],
        "equations": rec["equations"],
        "per_snapshot_train_error": rec["per_snapshot_train_error"],
        "per_snapshot_holdout_error": rec["per_snapshot_error"],
    }


def _figure_reports(
    fig_dir: str,
    cfg,
    spec,
    params: dict,
    x: np.ndarray,
    xd,
    recon,
    batch: dict,
    p,
    p2,
    sweep,
    mesh=None,
    history: Optional[dict] = None,
    forecast: Optional[dict] = None,
    stab: Optional[dict] = None,
    seed_rec_fig: Optional[tuple] = None,
) -> None:
    """Render the full visual report set (reference L8, SURVEY §2.8) — shared
    by ``run`` (post-training) and ``evaluate`` (imported checkpoints: the
    reference's ReadAndInference scripts render the same mode/reconstruction
    panels on loaded ``.pt`` files, ``DESMO-SR/...py:775-861``)."""
    from desmo_tpu import viz

    points, grid_shape, plane = viz.field_layout(mesh, x.shape[0])
    if history is not None:
        viz.loss_curve(history, os.path.join(fig_dir, "loss.png"))
    if cfg.variant == "ae":
        latent, _ = ae_model.encode_decode(params, xd)
    else:
        latent = desmo_model.effective_modes(params, batch["pod_modes"])
    viz.mode_fields(
        np.asarray(latent),
        np.asarray(params["omega"]),
        os.path.join(fig_dir, "modes.png"),
        points=points,
        grid_shape=grid_shape,
        plane=plane,
    )
    if "c" in params:
        # per-term poly-mode report (plot_poly_modes, CYL:820-849)
        viz.term_fields(
            np.asarray(latent),
            np.asarray(params["c"]),
            spec,
            os.path.join(fig_dir, "poly_terms.png"),
            points=points,
            grid_shape=grid_shape,
            plane=plane,
        )
    viz.true_vs_predicted(
        x,
        np.asarray(recon),
        timestep=min(300, cfg.m - 1),
        path=os.path.join(fig_dir, "reconstruction.png"),
        points=points,
        grid_shape=grid_shape,
        plane=plane,
        pod_recon=np.asarray(p.reconstruction),
    )
    viz.pod_spectrum(np.asarray(p2.singular_values), os.path.join(fig_dir, "pod_spectrum.png"))
    viz.sweep_curve(sweep, os.path.join(fig_dir, "sweep.png"))
    if cfg.variant == "fourier":
        t = jnp.asarray(fourier_model.t_points(cfg.m))
        z_plot, _ = fourier_model.temporal_values(params, t)
    else:
        z_plot = params["z"]
    viz.temporal_coefficients(np.asarray(z_plot), os.path.join(fig_dir, "temporal.png"))
    if forecast is not None and "per_snapshot_train_error" in forecast:
        # a failed forecast leaves an error record with no vectors — the
        # other figure reports still render
        viz.forecast_errors(
            forecast["per_snapshot_train_error"],
            forecast["per_snapshot_holdout_error"],
            os.path.join(fig_dir, "forecast.png"),
        )
    if stab is not None:
        viz.term_stability_bars(
            stab["names"], stab["frequency"],
            os.path.join(fig_dir, "term_stability.png"),
        )
    if seed_rec_fig is not None:
        labels, recs_list, best = seed_rec_fig
        viz.seed_recs(
            labels, recs_list, best, os.path.join(fig_dir, "seed_recs.png")
        )


def evaluate(
    cfg: configs.RunConfig,
    x: np.ndarray,
    checkpoint_path: str,
    echo: bool = True,
    device_mesh=None,
    figures_dir: Optional[str] = None,
    mesh=None,
    forecast_after: Optional[int] = None,
    forecast_engine: str = "stlsq",
) -> dict:
    """Load a ``.pt`` checkpoint (ours or the reference's), run inference, and
    report error + POD baselines + sparsification table — the reference's
    read-and-infer workflow (``DESMO-SR/...py:620-713``), no training.

    ``device_mesh`` (a ('space','time') mesh) row-shards X, the POD modes and
    therefore the (n, m) reconstruction over 'space' — inference at spatial
    sizes one device can't hold, same sharding story as ``run`` (the error /
    sweep reductions are psum'd by XLA's sharding propagation).

    ``figures_dir`` renders the same visual report set ``run`` produces
    (modes, per-term fields, true-vs-predicted, POD spectrum, sweep curve,
    temporal coefficients) on the IMPORTED checkpoint — the reference's
    ReadAndInference figures (``DESMO-SR/...py:775-861``); ``mesh`` (the
    snapshot mesh from ``load_data``) enables point/voxel-located rendering.

    ``forecast_after`` (all variants; beyond reference): the
    checkpoint was trained on the FIRST ``forecast_after`` snapshots of the
    given series — score a forecast at the held-out times beyond that
    window, no retraining (the evaluate-side counterpart of
    ``run(holdout=...)``; both splits re-centered on the train mean so no
    held-out statistic leaks). Fourier checkpoints evaluate the trained
    time-continuous series there; desmo/ae checkpoints chain the DESMO-SR
    leg (``_chained_forecast_record``: STLSQ-identified dz/dt integrated
    past the window). Adds a ``forecast`` record to the result."""
    x_hold = None
    if forecast_after:
        m_tr = int(forecast_after)
        if not 1 < m_tr < x.shape[1]:
            raise ValueError(
                f"forecast_after={m_tr} must split the series: data has "
                f"{x.shape[1]} snapshots and the held-out window needs >= 1"
            )
        mu_train = x[:, :m_tr].mean(axis=1, keepdims=True)
        x_hold = np.asarray(x[:, m_tr:] - mu_train)
        x = np.asarray(x[:, :m_tr] - mu_train)
    cfg = dataclasses.replace(cfg, n=x.shape[0], m=x.shape[1])
    sd = checkpoint.load_pt(checkpoint_path)
    # size the model from the CHECKPOINT — the reference trains different
    # ranks per experiment (the shipped SR checkpoint is r=2, P=2 on
    # cylinder data whose preset is r=4, P=3); AE checkpoints infer from the
    # encoder's last layer + len(c_coef) (ae_model.infer_spec_dims)
    if cfg.variant == "ae":
        r, poly_order = ae_model.infer_spec_dims(sd)
    else:
        r, poly_order = checkpoint.infer_spec_dims(sd)
    if (r, poly_order) != (cfg.r, cfg.poly_order):
        if echo:
            print(
                f"checkpoint is r={r}, P={poly_order} "
                f"(preset {cfg.r}, {cfg.poly_order}) — using checkpoint dims"
            )
        cfg = dataclasses.replace(cfg, r=r, poly_order=poly_order)
    if cfg.variant == "fourier" and "z_list.0" in sd:
        # series length = 2*nF + 1 coefficients per channel
        nf = (int(np.asarray(sd["z_list.0"]).reshape(-1).shape[0]) - 1) // 2
        if nf != cfg.n_fourier:
            cfg = dataclasses.replace(cfg, n_fourier=nf)
    spec, _params, _loss, _groups = build_model(cfg)
    if cfg.variant == "ae":
        params = ae_model.params_from_state_dict(sd)
    else:
        params = checkpoint.params_from_state_dict(sd, cfg.variant)
    # Imported checkpoints pair frozen phi masks with the SIGNS of the POD
    # modes they were trained against; compute_pod rebuilds the convention the
    # checkpoint was trained under (reference .pt = 'host'; our non-default
    # pod_method runs must evaluate with the SAME method — see compute_pod).
    p, p2 = compute_pod(cfg, x, device_mesh=device_mesh)
    xd = jnp.asarray(x)
    batch = {"x": xd, "x_sq": jnp.sum(xd * xd)}
    if cfg.variant != "ae":
        batch["pod_modes"] = p.modes
    if device_mesh is not None:
        # ONE sharding policy with run(): x -> ('space','time'), pod_modes ->
        # ('space', None), uneven axes degrade to replication (_drop_unfit)
        from desmo_tpu import parallel

        batch = parallel.shard_batch(batch, device_mesh)
    recon = reconstruct(params, batch, spec, cfg.variant)
    err = float(losses.relative_frobenius_error(batch["x"], recon))
    if echo:
        print(f"DESMO error with {cfg.r} modes: {err}")
        print(f"POD error with {cfg.r} modes: {pod.pod_relative_error(x, p)}")
        print(f"POD error with {2 * cfg.r} modes: {pod.pod_relative_error(x, p2)}")
    forecast = None
    if x_hold is not None:
        if cfg.variant == "fourier":
            forecast = _fourier_forecast_record(
                params, batch["pod_modes"], spec, cfg.m,
                batch["x"], recon, err, x_hold,
            )
        else:
            forecast = _chained_forecast_record(
                cfg, spec, checkpoint.device_fetch_tree(params),
                x, batch.get("pod_modes"), err, x_hold,
                log=print if echo else None, engine=forecast_engine,
            )
        if echo:
            print(
                f"forecast: checkpoint trained on {cfg.m} snapshots, held "
                f"out {forecast['m_holdout']}; train err {err:.6f}, HELD-OUT "
                f"err {forecast['holdout_error']:.6f}"
            )
    sweep = sparsify.threshold_sweep(
        params, batch, spec, variant=cfg.variant, log=print if echo else None
    )
    if figures_dir is not None:
        _figure_reports(
            figures_dir, cfg, spec, params, x, batch["x"], recon, batch,
            p, p2, sweep, mesh=mesh, forecast=forecast,
        )
    out = {
        "relative_error": err,
        "pod_error_r": pod.pod_relative_error(x, p),
        "pod_error_2r": pod.pod_relative_error(x, p2),
        "sweep": [(e.threshold, e.error, e.nonzero_terms) for e in sweep],
    }
    if forecast is not None:
        out["forecast"] = forecast
    return out
