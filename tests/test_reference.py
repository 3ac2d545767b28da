"""The float64 NumPy reference (desmo_tpu.reference): its gradient against
central finite differences, and the factored JAX training losses against it
for every preset at reduced n, m."""

import dataclasses

import numpy as np
import pytest

import jax

from desmo_tpu import configs, pod, reference, runner
from desmo_tpu.io import synthetic
from desmo_tpu.models import fourier


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(cfg):
    x = synthetic.cylinder_wake(cfg.n, cfg.m, seed=0)
    modes = None if cfg.variant == "ae" else np.asarray(pod.pod_host(x, cfg.r).modes)
    t = fourier.t_points(cfg.m) if cfg.variant == "fourier" else None
    return x, modes, t


# fp32 on the CPU against float64, measured ~3e-6 (loss) and ~5e-5 / ~2e-4
# (desmo-fourier / ae gradients) at these shapes: the bounds leave 5-10x room
@pytest.mark.parametrize("preset", configs.names())
def test_factored_loss_and_grad_match_float64_reference(preset):
    cfg = dataclasses.replace(configs.get(preset), n=96, m=40)
    _, params, loss_fn, _ = runner.build_model(cfg)
    x, modes, t = _inputs(cfg)
    batch = runner.prepare_chunk_batch(cfg, x, pod_modes=modes)
    (total, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch)
    ref_total, ref_grads = reference.loss_and_grad(
        cfg.variant, {k: np.asarray(v) for k, v in params.items()}, x,
        r=cfg.r, poly_order=cfg.poly_order, beta=cfg.beta,
        l1_lambda=cfg.l1_lambda, ae_beta=cfg.ae_beta, pod_modes=modes, t=t,
    )
    assert abs(float(total) - ref_total) <= 2e-5 * abs(ref_total)
    bound = 2e-3 if cfg.variant == "ae" else 5e-4
    assert set(ref_grads) == set(params)
    for k in params:
        assert _rel(grads[k], ref_grads[k]) <= bound, k


@pytest.mark.parametrize("variant", ["desmo", "fourier", "ae"])
def test_reference_gradient_matches_finite_differences(variant):
    """Central differences of the float64 loss at a handful of coordinates
    of every leaf (small omega so the differences resolve)."""
    preset = {"desmo": "aneurysm", "fourier": "fourier_cylinder", "ae": "ae_cylinder"}[variant]
    cfg = dataclasses.replace(
        configs.get(preset), n=24, m=12, omega_init=1.5, period_init=10.0,
        ae_beta=0.3 if variant == "ae" else 0.0,
    )
    _, params, _, _ = runner.build_model(cfg)
    rng = np.random.default_rng(7)
    # off the init (whose zero biases put ReLU inputs exactly on the kink):
    # every term and every sign pattern is exercised
    p = {k: np.asarray(v, np.float64) * (1.0 + 0.3 * rng.standard_normal(np.shape(v)))
         + 0.05 * rng.standard_normal(np.shape(v)) for k, v in params.items()}
    x, modes, t = _inputs(cfg)
    kw = dict(r=cfg.r, poly_order=cfg.poly_order, beta=0.7, l1_lambda=0.05,
              ae_beta=cfg.ae_beta, pod_modes=modes, t=t)
    _, grads = reference.loss_and_grad(variant, p, x, **kw)
    h = 1e-6
    for k, v in p.items():
        for idx in map(tuple, rng.integers(0, v.shape, size=(3, v.ndim))):
            up, dn = dict(p), dict(p)
            up[k], dn[k] = v.copy(), v.copy()
            up[k][idx] += h
            dn[k][idx] -= h
            fd = (reference.loss_and_grad(variant, up, x, **kw)[0]
                  - reference.loss_and_grad(variant, dn, x, **kw)[0]) / (2 * h)
            assert abs(fd - grads[k][idx]) <= 1e-5 * max(1.0, abs(fd)), (k, idx)
