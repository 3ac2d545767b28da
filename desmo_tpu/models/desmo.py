"""The core DESMO model as a pure function of a parameter pytree.

Reference: the ``DESMO(nn.Module)`` class at
``DESMO/cylinder_flow/DESMO-Cylinder.py:500-576``. Functional re-design notes:

* The reference's ``forward`` ignores its input tensor — reconstruction is a
  function of the parameters only. We make that explicit: ``apply(params,
  pod_modes, spec)`` takes no snapshot argument.
* POD modes are a closed-over constant of the jitted step, eliminating the
  per-step ``torch.from_numpy(POD_modes).to(device)`` host->device copy the
  reference performs on *every* forward (``CYL:538-541``).
* All per-mode parameter lists become stacked arrays (``phi (r, n)``,
  ``z (T, m)``, ``z_trig (3, r, m)``, ...), so the whole reconstruction is one
  GEMM ``(n, T+3r) @ (T+3r, m)`` instead of T cats plus 3r small outer
  products (``CYL:554-572``).

Parameter layout (names used across checkpointing / sharding / sparsify):

==========  ===========  ====================================================
key         shape        reference equivalent (``CYL`` line)
==========  ===========  ====================================================
phi         (r, n)       ``phi_list.{i}`` multiplicative masks (506)
c           (T,)         ``c_coef`` polynomial sparsity coefficients (513)
z           (T, m)       ``z_list.{t}`` temporal coefficients (516)
z_trig      (3, r, m)    ``zsin/zcos/ztanh_list.{i}`` (519-521), kind-major
c_trig      (3, r)       ``sin/cos/tanh_coef_list.{i}`` (524-526)
omega       (3, r)       ``omega_list.{3i+k}`` frequencies (530)
==========  ===========  ====================================================

Trig kind axis order is (sin, cos, tanh) — `desmo_tpu.library.TRIG_KINDS`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from desmo_tpu import library

Params = dict[str, jnp.ndarray]


@dataclasses.dataclass(frozen=True)
class DesmoSpec:
    """Static architecture description (shapes and hyper-structure only)."""

    n: int  # spatial points
    m: int  # snapshots
    r: int  # number of modes
    poly_order: int
    omega_init: float = 10000.0

    @property
    def num_poly_terms(self) -> int:
        return library.num_poly_terms(self.r, self.poly_order)

    @property
    def num_trig_terms(self) -> int:
        return 3 * self.r

    def factor_table(self) -> np.ndarray:
        return library.factor_table(self.r, self.poly_order)


def init_params(spec: DesmoSpec, dtype=jnp.float32) -> Params:
    """All-ones initialization, matching the reference (``CYL:506-530``)."""
    T = spec.num_poly_terms
    return {
        "phi": jnp.ones((spec.r, spec.n), dtype),
        "c": jnp.ones((T,), dtype),
        "z": jnp.ones((T, spec.m), dtype),
        "z_trig": jnp.ones((3, spec.r, spec.m), dtype),
        "c_trig": jnp.ones((3, spec.r), dtype),
        "omega": jnp.full((3, spec.r), spec.omega_init, dtype),
    }


def effective_modes(params: Params, pod_modes: jnp.ndarray) -> jnp.ndarray:
    """Learnable masks applied to frozen POD modes: ``latent (n, r)``.

    ``phi_i = p_i * POD_i`` elementwise (``CYL:538-541``)."""
    return pod_modes * params["phi"].T


def trig_basis(latent: jnp.ndarray, omega: jnp.ndarray) -> jnp.ndarray:
    """Nonlinear spatial basis ``(3, r, n)``: sin/cos/tanh of omega-scaled modes.

    Row k, mode i = f_k(omega[k, i] * latent[:, i]) (``CYL:565-567``)."""
    args = omega[:, :, None] * latent.T[None, :, :]  # (3, r, n)
    return jnp.stack(
        [jnp.sin(args[0]), jnp.cos(args[1]), jnp.tanh(args[2])], axis=0
    )


def spatial_dictionary(
    params: Params, pod_modes: jnp.ndarray, factors
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Assemble the full spatial dictionary ``A (n, T + 3r)`` and latent modes.

    Columns 0..T-1 are the c-scaled polynomial library; columns T.. are the
    coefficient-scaled trig terms in kind-major order (matching z rows).
    """
    latent = effective_modes(params, pod_modes)  # (n, r)
    theta = library.eval_library(latent, factors)  # (n, T)
    theta_c = theta * params["c"][None, :]
    basis = trig_basis(latent, params["omega"])  # (3, r, n)
    g = (params["c_trig"][:, :, None] * basis).reshape(-1, latent.shape[0]).T
    return jnp.concatenate([theta_c, g], axis=1), latent


def temporal_matrix(params: Params) -> jnp.ndarray:
    """Stacked temporal coefficients ``B (T + 3r, m)``, rows matching A's cols."""
    z_trig = params["z_trig"].reshape(-1, params["z_trig"].shape[-1])
    return jnp.concatenate([params["z"], z_trig], axis=0)


def apply(
    params: Params,
    pod_modes: jnp.ndarray,
    spec: DesmoSpec,
    factors=None,
    precision=jax.lax.Precision.HIGHEST,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full reconstruction.

    Returns ``(recon (n, m), latent (n, r), z (T, m))`` — the reference returns
    the transpose ``(m, n)`` (``CYL:576``); we keep the snapshot-matrix layout
    (space-major) throughout and transpose only at the loss.

    ``precision=HIGHEST`` forces true fp32 contractions (no bf16 or TF32
    operand rounding): with omega ~ 1e4 inside sin/cos, reduced-precision
    matmuls visibly perturb convergence (SURVEY §7 "hard parts").
    """
    if factors is None:
        factors = spec.factor_table()
    A, latent = spatial_dictionary(params, pod_modes, factors)
    B = temporal_matrix(params)
    recon = jnp.dot(A, B, precision=precision)
    return recon, latent, params["z"]


def build_loss(spec: DesmoSpec, beta: float, l1_lambda: float, method: str = "factored"):
    """Composite training loss closure for the main DESMO model.

    ``batch = {'x': X (n, m), 'pod_modes': (n, r)[, 'x_sq': sum(X*X)]}``.
    Returns ``(total, {'rec','ortho','l1'})`` matching ``CYL:713-733``.

    method='factored' (default) computes the reconstruction MSE through Gram
    products without materializing the (n, m) reconstruction — identical value
    up to fp32 rounding (tested), several times less HBM traffic per step.
    method='direct' materializes the reconstruction like the reference.
    """
    from desmo_tpu import losses

    if method not in ("factored", "direct"):
        raise ValueError(f"desmo loss method {method!r}: use 'factored' or 'direct'")
    factors = spec.factor_table()

    def loss_fn(params: Params, batch: dict):
        if method == "factored":
            A, latent = spatial_dictionary(params, batch["pod_modes"], factors)
            B = temporal_matrix(params)
            rec = losses.factored_mse(A, B, batch["x"], batch.get("x_sq"))
        else:
            recon, latent, _ = apply(params, batch["pod_modes"], spec, factors)
            rec = losses.mse(recon, batch["x"])
        ortho = losses.orthogonality(latent)
        l1 = losses.sparsity_l1(params)
        total = rec + beta * ortho + l1_lambda * l1
        return total, {"rec": rec, "ortho": ortho, "l1": l1}

    return loss_fn


def param_group(path: str) -> str:
    """Optimizer group of a parameter, mirroring the reference's LR groups.

    ``CYL:592-612``: sparsity coefficients (c, c_trig) lr=1e-2; phi lr=1e-3;
    temporal (z, z_trig) lr=1e-2; omega lr=1e3.
    """
    return {
        "phi": "phi",
        "c": "coef",
        "c_trig": "coef",
        "z": "z",
        "z_trig": "z",
        "omega": "omega",
        # Fourier-temporal variant extras (DESMO_Fourier/...py:629-632)
        "period": "period",
        "trig_period": "period",
    }[path]


def param_groups(params: Params) -> dict[str, str]:
    """Group label per top-level param key (works for all model variants)."""
    return {k: param_group(k) for k in params}


def count_params(params: Any) -> int:
    return sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
