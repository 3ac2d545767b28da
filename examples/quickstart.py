"""End-to-end DESMO workflow in one script — the framework equivalent of a
full reference run (train -> sparsify -> identify dynamics -> FORECAST ->
export), on synthetic data so it works out of the box:

    python examples/quickstart.py [--epochs 20000] [--out runs/quickstart]

Steps:
1.  train the cylinder preset on the first 90% of the series and report
    error vs the POD baselines;
2.  threshold-sweep the term energies (the reference's sparsification table);
3.  the DESMO-SR stage, chained in-run by ``holdout``: STLSQ-identified
    dz/dt = f(z) integrated PAST the training window and scored on the
    held-out 10% — an honest forecast no reference script makes;
4.  export a torch-loadable ``.pt`` checkpoint and re-import it, proving the
    reference-interchange round trip.

For a distributed run, pass ``--mesh space=4`` (or use the CLI:
``python -m desmo_tpu run --preset cylinder --synthetic --mesh space=4``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20000)
    ap.add_argument("--out", default="runs/quickstart")
    ap.add_argument(
        "--platform", default=None, help="force a JAX platform (e.g. cpu)"
    )
    args = ap.parse_args()

    if args.platform:
        # must land before the first backend touch
        import jax

        jax.config.update("jax_platforms", args.platform)

    from desmo_tpu import checkpoint, configs, runner
    from desmo_tpu.io import synthetic

    # -- 1. train (on the first 90% — the last 10% is the forecast target) --
    cfg = configs.get("cylinder")
    x = synthetic.cylinder_wake(cfg.n, cfg.m, n_harmonics=4, noise=0.002, seed=0)
    art = runner.run(
        cfg, x, out_dir=args.out, num_epochs=args.epochs,
        make_figures=True, echo=False, holdout=0.1,
    )
    print(f"DESMO({cfg.r}) error {art.relative_error:.4f}  "
          f"[POD({cfg.r}) {art.pod_error_r:.4f}, POD({2*cfg.r}) {art.pod_error_2r:.4f}]")
    if art.steps_per_sec == art.steps_per_sec:  # not NaN
        print(f"throughput {art.steps_per_sec:,.0f} optimizer steps/s")

    # -- 2. sparsification table (printed by run; show the knee) -----------
    best = min(art.sweep, key=lambda e: (e.error, e.nonzero_terms))
    print(f"sweep: best error {best.error:.4f} at threshold "
          f"{best.threshold:.1e} with {best.nonzero_terms} surviving terms")

    # -- 3. DESMO-SR, chained by holdout: identified dynamics + forecast ---
    import numpy as np

    f = art.forecast
    if "error" in f:  # contained failure — the run's artifacts still saved
        print(f"forecast failed: {f['error']}")
    else:
        for eq in f["equations"]:
            print(eq)
        in_window = float(np.median(f["per_snapshot_train_error"]))
        print(f"held-out FORECAST ({f['m_holdout']} unseen snapshots, engine "
              f"{f['engine']}{', stabilized' if f.get('stabilized') else ''}): "
              f"rel err {f['holdout_error']:.4f} (same-model in-window median "
              f"{in_window:.4f}; figures/forecast.png has the horizon curve)")

    # -- 4. torch interchange round trip -----------------------------------
    pt = os.path.join(art.out_dir, "quickstart_export.pt")
    checkpoint.save_pt(pt, checkpoint.state_dict_from_params(
        checkpoint.device_fetch_tree(art.state.params), cfg.variant))
    sd = checkpoint.load_pt(pt)
    r, poly = checkpoint.infer_spec_dims(sd)
    print(f"exported {pt} (torch-loadable) and re-imported: r={r}, P={poly}, "
          f"{len(sd)} arrays")
    print(f"artifacts in {art.out_dir} (figures/, metrics CSV/JSONL, checkpoints)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
