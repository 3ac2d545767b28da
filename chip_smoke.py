"""On-card smoke run: DESMO training end to end on an NVIDIA GPU.

    python chip_smoke.py [--out DIR]           # one GPU: every phase below
    python chip_smoke.py --devices 4 [--out DIR]   # four GPUs: the mesh phase only

One process. Each phase prints its result and the run stops with a nonzero
exit code at the first phase that fails; with no GPU it stops before any
phase. Phases (one GPU):

1. device: JAX's platform, device kind and count, the jax/jaxlib versions,
   and ``nvidia-smi``'s name and power limit (read by a child process);
2. correctness: the factored training loss and its gradient of every preset
   at its full width, at the preset init on the synthetic wake, against the
   float64 NumPy direct reference (``desmo_tpu.reference``);
3. cli: ``python -m desmo_tpu run --synthetic`` of cylinder and aneurysm,
   in-process through ``desmo_tpu.__main__.main``;
4. presets: ``runner.run`` of all six presets for two checkpoint chunks, then
   the 4-seed packed ensemble on aneurysm;
5. trace: a ``jax.profiler`` window of the aneurysm scan chunk, with the
   device time of the two X contractions (``A^T X`` and autodiff's ``X B^T``).

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import glob
import io
import json
import os
import re
import sys
import time

import numpy as np

from desmo_tpu import configs, runtime

PRESETS = (
    "cylinder", "aneurysm", "channel", "fourier_cylinder", "fourier_aneurysm", "ae_cylinder",
)
# Bounds on the relative error against the float64 reference, per variant.
# Loss: every contraction runs at Precision.HIGHEST (true fp32) and the loss
# is a mean over n*m squares, so fp32 rounding stays near 1e-6.
# Gradient (||g - g_ref|| / ||g_ref|| per leaf): the phi, omega and encoder
# gradients pass through cos(omega * latent) with omega = 1e4 at the preset
# init, so a relative rounding of 6e-8 in the latent becomes an argument
# error of up to 1e4 * |latent| * 6e-8 per point before the sum over n. On
# one H100 the largest errors were 2.2e-6 (loss), 1.1e-4 (fourier
# trig_period) and 1.7e-3 (the AE encoder, whose latent carries seven layers
# of rounding); TF32 contractions put the AE encoder gradient 128% off.
TOLERANCE = {
    "desmo": {"loss": 1e-4, "grad": 1e-3},
    "fourier": {"loss": 1e-4, "grad": 1e-3},
    "ae": {"loss": 1e-4, "grad": 1e-2},
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet; the X-read floor below


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    try:
        yield
    except BaseException:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s", flush=True)
        raise
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / (den if den > 0 else 1.0))


def _cfg(preset: str, shape=None):
    cfg = configs.get(preset)
    if shape is not None:
        cfg = dataclasses.replace(cfg, n=shape[0], m=shape[1])
    return cfg


def device_info(expect_count: int) -> dict:
    """Phase 1. ``runtime.require_gpu`` has already refused a non-GPU."""
    import jax
    import jaxlib

    devices = runtime.require_gpu()
    if len(devices) != expect_count:
        raise RuntimeError(f"expected {expect_count} GPUs, JAX found {len(devices)}")
    card = runtime.gpu_name_and_power_limit()
    info = {"platform": devices[0].platform, "kind": devices[0].device_kind, "count": len(devices)}
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}; devices {info}")
    print(f"nvidia-smi name, power.limit: {card}", flush=True)
    return {**info, "card": card.replace("\n", " | ")}


def check_correctness(preset: str, shape=None) -> dict:
    """Factored loss + gradient on the default device vs the float64 direct
    reference, at the preset init on ``cylinder_wake(n, m, seed=0)``."""
    import jax

    from desmo_tpu import pod, reference, runner
    from desmo_tpu.io import synthetic
    from desmo_tpu.models import fourier

    cfg = _cfg(preset, shape)
    _, params, loss_fn, _ = runner.build_model(cfg)
    x = synthetic.cylinder_wake(cfg.n, cfg.m, seed=0)
    modes = None if cfg.variant == "ae" else np.asarray(pod.pod_host(x, cfg.r).modes)
    batch = runner.prepare_chunk_batch(cfg, x, pod_modes=modes)
    (total, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    ref_total, ref_grads = reference.loss_and_grad(
        cfg.variant, {k: np.asarray(v) for k, v in params.items()}, x,
        r=cfg.r, poly_order=cfg.poly_order, beta=cfg.beta,
        l1_lambda=cfg.l1_lambda, ae_beta=cfg.ae_beta, pod_modes=modes,
        t=fourier.t_points(cfg.m) if cfg.variant == "fourier" else None,
    )
    return {
        "loss": abs(float(total) - ref_total) / abs(ref_total),
        "grad": {k: _rel(grads[k], ref_grads[k]) for k in ref_grads},
    }


def phase_correctness(presets=PRESETS, shape=None) -> dict:
    """Phase 2: every preset's errors are printed before any bound fails."""
    out, failures = {}, []
    for preset in presets:
        err = check_correctness(preset, shape)
        tol = TOLERANCE[configs.get(preset).variant]
        worst = max(err["grad"], key=err["grad"].get)
        print(
            f"  {preset:17s} loss rel err {err['loss']:.3e} (bound {tol['loss']:g}); "
            f"grad rel err max {err['grad'][worst]:.3e} at {worst} (bound {tol['grad']:g}); "
            + " ".join(f"{k}={v:.2e}" for k, v in err["grad"].items()),
            flush=True,
        )
        if err["loss"] > tol["loss"] or err["grad"][worst] > tol["grad"]:
            failures.append(preset)
        out[preset] = err
    if failures:
        raise AssertionError(f"outside the stated tolerance: {failures}")
    return out


def _rec_history(run_dir: str, name: str) -> np.ndarray:
    with open(os.path.join(run_dir, f"{name}.csv")) as fh:
        return np.asarray([float(row["rec"]) for row in csv.DictReader(fh)])


def phase_cli(out_dir: str, card: str, presets=("cylinder", "aneurysm"), epochs: int = 4000) -> dict:
    """Phase 3: the CLI's ``run`` in this process. The run's epoch lines are
    captured; its summary line, the card and the rec trend are printed."""
    from desmo_tpu import __main__ as cli

    out = {}
    for preset in presets:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([
                "run", "--preset", preset, "--synthetic", "--epochs", str(epochs),
                "--no-figures", "--out-dir", out_dir,
            ])
        if rc != 0:
            raise RuntimeError(f"cli run {preset} exited {rc}")
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        rec = _rec_history(os.path.join(out_dir, preset), preset)
        print(
            f"  cli run {preset}: steps_per_sec {summary['steps_per_sec']} on "
            f"[{card}]; relative_error {summary['relative_error']:.6f}; rec "
            f"{rec[0]:.6e} -> {rec[-1]:.6e} over {len(rec)} logged epochs",
            flush=True,
        )
        if not np.isfinite(summary["relative_error"]):
            raise AssertionError(f"{preset}: non-finite relative_error")
        if not rec[-1] < rec[0]:
            raise AssertionError(f"{preset}: rec did not fall ({rec[0]} -> {rec[-1]})")
        out[preset] = summary
    return out


def _run_preset(cfg, out_dir: str):
    import jax

    from desmo_tpu import runner
    from desmo_tpu.io import synthetic

    x = synthetic.cylinder_wake(cfg.n, cfg.m, seed=0)
    art = runner.run(cfg, x, out_dir=out_dir, make_figures=False, echo=False)
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "n/a")
    seeds = f" x {cfg.n_seeds} seeds" if cfg.n_seeds > 1 else ""
    print(
        f"  {cfg.name:17s}{seeds} n={cfg.n} m={cfg.m}: steps_per_sec "
        f"{art.steps_per_sec:.1f} ({'seed-steps' if seeds else 'steps'}/s, second "
        f"chunk); relative_error {art.relative_error:.6f}; process "
        f"peak_bytes_in_use {peak}",
        flush=True,
    )
    if not np.isfinite(art.relative_error):
        raise AssertionError(f"{cfg.name}: non-finite relative_error")
    return art


def phase_presets(out_dir: str, presets=PRESETS, chunk: int = 1000, shape=None) -> dict:
    """Phase 4: two checkpoint chunks per preset through ``runner.run``
    (the second chunk's rate excludes compilation), then the packed ensemble
    (``ensemble.make_ensemble_chunk``) with 4 seeds on aneurysm."""
    out = {}
    for preset in presets:
        cfg = dataclasses.replace(_cfg(preset, shape), checkpoint_every=chunk, num_epochs=2 * chunk)
        out[preset] = _run_preset(cfg, out_dir).steps_per_sec
    ens = dataclasses.replace(
        _cfg("aneurysm", shape), name="aneurysm_seeds4", n_seeds=4,
        checkpoint_every=chunk, num_epochs=2 * chunk,
    )
    out[ens.name] = _run_preset(ens, out_dir).steps_per_sec
    return out


def _hlo_scope_ops(hlo_text: str, scope: str) -> dict:
    """HLO instruction name -> 'fwd'/'bwd' for every instruction whose own
    op_name, or that of an instruction in the fusion it calls, is in
    ``scope`` (backward = under autodiff's ``transpose(...)``)."""
    comps, current = {}, None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if head and not line.startswith(" "):
            current = comps.setdefault(head.group(1), [])
        elif current is not None and "=" in line:
            current.append(line)

    # the scope shows as ".../x_contraction/dot_general" or, under a
    # transform, as "jvp(x_contraction)/dot_general"
    in_scope = re.compile(rf"(^|[/(]){re.escape(scope)}([/)]|$)")

    def names_in(lines, seen):
        found = []
        for ln in lines:
            op = re.search(r'op_name="([^"]*)"', ln)
            if op and in_scope.search(op.group(1)):
                found.append(op.group(1))
            for callee in re.findall(r"calls=%?([\w.\-]+)", ln):
                if callee not in seen:
                    seen.add(callee)
                    found += names_in(comps.get(callee, []), seen)
        return found

    out = {}
    for lines in comps.values():
        for ln in lines:
            name = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", ln)
            if not name:
                continue
            ops = names_in([ln], set())
            if ops:
                out[name.group(1)] = "bwd" if any("transpose(" in o for o in ops) else "fwd"
    return out


def x_contraction_times(trace_dir: str, hlo_text: str, plane_prefix: str, steps: int) -> dict:
    """Device time per step of the forward and backward X contractions, from
    the newest ``.xplane.pb`` under ``trace_dir``. Events are matched by their
    ``hlo_op`` stat against the compiled HLO's ``x_contraction`` scope."""
    from jax.profiler import ProfileData

    from desmo_tpu import losses

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    planes = [p for p in ProfileData.from_file(path).planes if p.name.startswith(plane_prefix)]
    if not planes:
        raise AssertionError(f"no {plane_prefix!r} plane in {path}")
    kinds = _hlo_scope_ops(hlo_text, losses.X_CONTRACTION_SCOPE)
    if not kinds:
        raise AssertionError("no x_contraction instruction in the compiled HLO")
    total = {"fwd": 0.0, "bwd": 0.0}
    names = {"fwd": set(), "bwd": set()}
    lines_seen = set()
    by_op: dict = {}
    for plane in planes:
        lines = list(plane.lines)
        streams = [ln for ln in lines if "stream" in ln.name.lower()] or lines
        for line in streams:
            lines_seen.add(f"{plane.name}:{line.name}")
            for ev in line.events:
                op = {k: v for k, v in ev.stats}.get("hlo_op")
                key = f"{op}:{ev.name}"
                by_op[key] = by_op.get(key, 0.0) + ev.duration_ns
                kind = kinds.get(op)
                if kind is not None:
                    total[kind] += ev.duration_ns
                    names[kind].add(f"{op}:{ev.name}")
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    if not (total["fwd"] and total["bwd"]):
        raise AssertionError(
            f"x_contraction events not found on {sorted(lines_seen)}: {total}; "
            f"scoped HLO ops {kinds}; busiest events {top}"
        )
    return {
        "top_us_per_step": [(k, v / steps / 1e3) for k, v in top],
        "fwd_us_per_step": total["fwd"] / steps / 1e3,
        "bwd_us_per_step": total["bwd"] / steps / 1e3,
        "events": {k: sorted(v) for k, v in names.items()},
        "lines": sorted(lines_seen),
    }


def phase_trace(out_dir: str, preset: str = "aneurysm", steps: int = 20, shape=None,
                plane_prefix: str = "/device:GPU:") -> dict:
    """Phase 5: one traced chunk of the scan path; the trace must hold a
    device plane, and the two X contractions are timed from it."""
    import jax
    import jax.numpy as jnp

    from desmo_tpu import pod, profiling, runner, train
    from desmo_tpu.io import synthetic

    cfg = _cfg(preset, shape)
    _, params, loss_fn, groups = runner.build_model(cfg)
    x = synthetic.cylinder_wake(cfg.n, cfg.m, seed=0)
    batch = runner.prepare_chunk_batch(cfg, x, pod_modes=pod.pod_host(x, cfg.r).modes)
    state = jax.tree.map(jnp.array, train.init_state(params, cfg))
    chunk = train.make_train_chunk(loss_fn, groups, cfg)
    # The traced executable is the one whose HLO names the events. Kernels
    # launched from a CUDA graph (XLA's command buffers) carry only the
    # graph's name, so this compile launches each kernel on its own; kernel
    # durations are the same, the gaps between them are not.
    compiled = chunk.lower(state, batch, num_steps=steps).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""}
    )
    state, metrics = compiled(state, batch)
    jax.block_until_ready((state, metrics))
    trace_dir = os.path.join(out_dir, "trace")
    with profiling.trace(trace_dir):
        state, metrics = compiled(state, batch)
        jax.block_until_ready((state, metrics))
    times = x_contraction_times(trace_dir, compiled.as_text(), plane_prefix, steps)
    floor_us = cfg.n * cfg.m * 4 / HBM_BYTES_PER_S * 1e6
    print(
        f"  {preset} x_contraction device time per step: A^T X "
        f"{times['fwd_us_per_step']:.2f} us, X B^T {times['bwd_us_per_step']:.2f} us; "
        f"one fp32 read of X at {HBM_BYTES_PER_S / 1e12:g} TB/s is {floor_us:.2f} us "
        f"(two: {2 * floor_us:.2f} us)",
        flush=True,
    )
    print(f"  trace lines {times['lines']}; x_contraction events {times['events']}")
    print("  busiest events (hlo_op:kernel, us/step): " + "; ".join(
        f"{k} {v:.2f}" for k, v in times["top_us_per_step"]), flush=True)
    return times


def phase_mesh(out_dir: str, n_devices: int = 4, presets=("aneurysm", "fourier_aneurysm"),
               chunk: int = 100, shape=None, rtol: float = 1e-3) -> dict:
    """``runner.run`` over a ('space',) mesh of ``n_devices`` against the
    same seeds on one device, in this process. Each device must hold an
    (r, n / n_devices) block of phi, and the mesh, which only reorders fp32
    sums, must reproduce the first and final rec within ``rtol``. The
    comparison trains with lr_omega = 1: at the presets' 1e3 (against omega
    1e4) training is chaotic, and rounding-order differences grow to O(1)
    within ~5 steps on any two devices."""
    import jax

    from desmo_tpu import runner
    from desmo_tpu.io import synthetic
    from desmo_tpu.parallel import make_mesh

    mesh = make_mesh(n_space=n_devices, devices=jax.devices()[:n_devices])
    out = {}
    for preset in presets:
        cfg = dataclasses.replace(
            _cfg(preset, shape), checkpoint_every=chunk, num_epochs=2 * chunk, lr_omega=1.0
        )
        x = synthetic.cylinder_wake(cfg.n, cfg.m, seed=0)
        sharded = runner.run(cfg, x, out_dir=os.path.join(out_dir, "mesh"),
                             make_figures=False, echo=False, device_mesh=mesh)
        single = runner.run(cfg, x, out_dir=os.path.join(out_dir, "single"),
                            make_figures=False, echo=False)
        rec_mesh = np.asarray(sharded.history["rec"])[[0, -1]].astype(float)
        rec_one = np.asarray(single.history["rec"])[[0, -1]].astype(float)
        diff = np.abs(rec_mesh - rec_one) / np.abs(rec_one)
        shard = next(iter(sharded.state.params["phi"].addressable_shards)).data.shape
        print(
            f"  {preset}: rec first/final mesh {rec_mesh[0]:.9e} / {rec_mesh[1]:.9e}, "
            f"one device {rec_one[0]:.9e} / {rec_one[1]:.9e} (rel diff {diff[0]:.2e} / "
            f"{diff[1]:.2e}, bound {rtol:g}); phi shard {shard}; steps_per_sec mesh "
            f"{sharded.steps_per_sec:.1f}, one device {single.steps_per_sec:.1f}",
            flush=True,
        )
        if shard != (cfg.r, cfg.n // n_devices):
            raise AssertionError(f"{preset}: phi shard {shard} != {(cfg.r, cfg.n // n_devices)}")
        if not (diff <= rtol).all():
            raise AssertionError(f"{preset}: mesh and single-device rec differ")
        out[preset] = {"rec_mesh": rec_mesh.tolist(), "rec_single": rec_one.tolist()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 = run only the four-GPU mesh phase")
    ap.add_argument("--out", default=os.path.join(runtime.REPO_ROOT, "runs", "chip_smoke"),
                    help="directory for run artifacts and the trace")
    args = ap.parse_args(argv)
    runtime.enable_compile_cache()
    runtime.require_gpu()
    with phase("device"):
        info = device_info(args.devices)
    if args.devices == 4:
        with phase("mesh"):
            phase_mesh(args.out, n_devices=4)
    else:
        with phase("correctness"):
            phase_correctness()
        with phase("cli"):
            phase_cli(os.path.join(args.out, "cli"), info["card"])
        with phase("presets"):
            phase_presets(os.path.join(args.out, "presets"))
        with phase("trace"):
            phase_trace(args.out)
    print(json.dumps({"ok": True, "device": {k: info[k] for k in ("platform", "kind", "count")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
