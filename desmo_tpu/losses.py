"""Loss terms for DESMO training.

Composite objective (``DESMO/cylinder_flow/DESMO-Cylinder.py:713-733``):

    total = MSE(recon, X) + beta * ortho(latent) + l1_lambda * L1(coefs)

* MSE over all (m*n) entries.
* ortho = sum over mode pairs i<j of |phi_i . phi_j| — the reference computes
  ``torch.norm(latent[:, i] @ latent[:, j].T, p='fro')`` of a *scalar* dot
  product, i.e. its absolute value (``CYL:717-720``). We compute the Gram
  matrix once and sum |off-diagonal| of the upper triangle — identical value,
  one GEMM instead of r(r-1)/2 dots.
* L1 over the sparsity coefficients only (c and the 3r trig scalars), NOT over
  z or omega (``CYL:725-731``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

X_CONTRACTION_SCOPE = "x_contraction"


def mse(recon_nm: jnp.ndarray, x_nm: jnp.ndarray) -> jnp.ndarray:
    """Mean squared error over the full (n, m) snapshot matrix."""
    d = recon_nm - x_nm
    return jnp.mean(d * d)


def factored_mse(
    a_nk: jnp.ndarray,
    b_km: jnp.ndarray,
    x_nm: jnp.ndarray,
    x_sq: jnp.ndarray | None = None,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """``mean((A @ B - X)^2)`` without ever materializing the (n, m) product.

    Uses ``||AB||_F^2 = <A^T A, B B^T>`` and ``<AB, X> = <A^T X, B>``: every
    intermediate is (n, K), (K, m) or (K, K) with K = T + 3r ~ 50, so the
    training step's memory traffic drops from O(n*m) writes+reads of the
    reconstruction to reads of X alone. Autodiff of this expression yields
    exactly the normal-equation gradients ``2/nm (A B B^T - X B^T)`` /
    ``2/nm (A^T A B - A^T X)`` — again GEMM-shaped with no (n, m)
    intermediate; X is read for ``A^T X`` in the forward pass and again for
    ``X B^T`` in the backward pass.

    ``x_sq``: precomputed ``sum(X*X)`` (X is constant across the training
    loop; passing it saves one full read of X per step).
    """
    ga = jnp.dot(a_nk.T, a_nk, precision=precision)  # (K, K)
    gb = jnp.dot(b_km, b_km.T, precision=precision)  # (K, K)
    # the one read of X in the forward pass; autodiff's X B^T inherits the
    # scope, so a profiler trace finds both X contractions by this name
    with jax.named_scope(X_CONTRACTION_SCOPE):
        ax = jnp.dot(a_nk.T, x_nm, precision=precision)  # (K, m)
    if x_sq is None:
        x_sq = jnp.sum(x_nm * x_nm)
    sq = jnp.sum(ga * gb) - 2.0 * jnp.sum(ax * b_km) + x_sq
    return sq / (x_nm.shape[0] * x_nm.shape[1])


def orthogonality(latent_nr: jnp.ndarray, precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """Sum of |pairwise dot products| between effective modes (i < j)."""
    gram = jnp.dot(latent_nr.T, latent_nr, precision=precision)  # (r, r)
    r = gram.shape[0]
    iu = jnp.triu(jnp.ones((r, r), dtype=bool), k=1)
    return jnp.sum(jnp.where(iu, jnp.abs(gram), 0.0))


def sparsity_l1(params: dict) -> jnp.ndarray:
    """L1 norm of the sparsity coefficients (c plus all trig coefficients)."""
    total = jnp.sum(jnp.abs(params["c"]))
    if "c_trig" in params:
        total = total + jnp.sum(jnp.abs(params["c_trig"]))
    return total


def relative_frobenius_error(x_nm: jnp.ndarray, recon_nm: jnp.ndarray) -> jnp.ndarray:
    """``||X - Xhat||_F / ||X||_F`` — the reference's headline metric (``CYL:1029``)."""
    return jnp.linalg.norm(x_nm - recon_nm) / jnp.linalg.norm(x_nm)


def per_snapshot_relative_error(
    x_nm: jnp.ndarray, recon_nm: jnp.ndarray
) -> jnp.ndarray:
    """Column-wise ``||x_j - xhat_j|| / ||x_j||`` — the error at each snapshot
    individually (length-m vector); :func:`relative_frobenius_error` is the
    whole-matrix aggregate. Used by the holdout/forecast reports to show how
    error grows with forecast horizon."""
    num = jnp.linalg.norm(x_nm - recon_nm, axis=0)
    den = jnp.linalg.norm(x_nm, axis=0)
    return num / jnp.maximum(den, 1e-30)
