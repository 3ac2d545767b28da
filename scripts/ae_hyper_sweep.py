"""AE recipe hyper multi-start on the full-length synthetic cylinder.

VERDICT r4 weak #5 / next #5: the round-3 hand-tuned recipe point reaches
err 0.1361 — beats POD(2)=0.2702 but not POD(4)=0.1228. This script runs the
grid the framework's multi-start machinery cannot pack (the AE MLP is not
seed-packable): sequential full-length runs over (ae_beta, warmup epochs,
lr scale), one after another on the accelerator.

    python scripts/ae_hyper_sweep.py [--epochs 100000] [--preset ae_cylinder]
Prints one JSON line per grid point + a final summary line with the winner.
"""

import argparse
import dataclasses
import itertools
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="ae_cylinder")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--out-dir", default="runs/ae_sweep")
    ap.add_argument("--ae-betas", default="1,3,10")
    ap.add_argument("--warmups", default="2000,6000,12000")
    ap.add_argument("--lr-scales", default="1")
    args = ap.parse_args()

    from desmo_tpu import configs, runner
    from desmo_tpu.io import synthetic

    base = configs.get(args.preset)
    x = synthetic.cylinder_wake(base.n, base.m, n_harmonics=4, noise=0.002, seed=0)
    grid = list(
        itertools.product(
            [float(v) for v in args.ae_betas.split(",")],
            [int(v) for v in args.warmups.split(",")],
            [float(v) for v in args.lr_scales.split(",")],
        )
    )
    rows = []
    for ae_beta, warmup, s in grid:
        # NOTE: the recipe clamps ae_beta to >= 10.0 and lr_z to <= 1e-3
        # (runner.ae_recipe_cfg; the floor IS this sweep's winner) — sweep
        # values below those are inert.
        cfg = dataclasses.replace(
            base,
            ae_recipe=True,
            ae_beta=ae_beta,
            ae_warmup_epochs=warmup,
            lr_coef=base.lr_coef * s,
            lr_phi=base.lr_phi * s,
            lr_z=base.lr_z * s,
        )
        t0 = time.time()
        try:
            art = runner.run(
                cfg, x, out_dir=args.out_dir, num_epochs=args.epochs,
                make_figures=False, echo=False,
            )
            row = {
                "ae_beta": ae_beta, "warmup": warmup, "lr_scale": s,
                "err": round(art.relative_error, 6),
                "pod_r": round(art.pod_error_r, 6),
                "pod_2r": round(art.pod_error_2r, 6),
                "wall_s": round(time.time() - t0, 1),
            }
        except Exception as e:  # record the point, keep sweeping
            row = {
                "ae_beta": ae_beta, "warmup": warmup, "lr_scale": s,
                "error": repr(e), "wall_s": round(time.time() - t0, 1),
            }
        rows.append(row)
        print(json.dumps(row), flush=True)
    done = [r for r in rows if "err" in r]
    if done:
        best = min(done, key=lambda r: r["err"])
        print(json.dumps({"winner": best, "n_grid": len(grid)}))
    return 0 if done else 1


if __name__ == "__main__":
    raise SystemExit(main())
