"""DESMOFourier: temporal coefficients as learnable truncated Fourier series.

Reference: ``DESMO_Fourier/cylinder_flow/DESMO-Cylinder.py:485-600`` and
``DESMO_Fourier/aneurysm/DESMOFourier_v2.py:541-624``. Each temporal channel
(every polynomial term and every trig channel) owns ``2*nF + 1`` series
coefficients plus a learnable period:

    z(t) = a0 + sum_{k=1..nF} a_k cos(2 pi k t / T) + b_k sin(2 pi k t / T)

evaluated on ``t_points = linspace(0, m, m)`` (endpoint included — a reference
quirk, step m/(m-1), ``...py:485``). This shrinks temporal parameters from
O(T*m) to O(T*nF) and makes the model time-continuous (periodic flows only,
``README.md:19-20``).

Redesign: the reference evaluates the series with an O(nF) Python loop of
small tensor ops *per channel per step* (``...py:487-506``) — the reason the
Fourier variant is *slower* than plain DESMO despite 8x fewer parameters
(18 vs 28 steps/s, SURVEY §3.2). Here every channel's series is one batched
einsum over a shared (nF, m) angle grid: two GEMMs total per forward.

Parameter layout = `desmo` plus:

============  ============  ===============================================
key           shape         reference equivalent
============  ============  ===============================================
z             (T, 2nF+1)    ``z_list.{t}`` series coefficients (:527)
period        (T,)          ``period_list.{t}`` (:528)
z_trig        (3, r, 2nF+1) ``zsin/zcos/ztanh_list.{i}`` (:532-534)
trig_period   (3, r)        ``trig_period_list.{3i+k}`` (:529)
============  ============  ===============================================
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from desmo_tpu.models import desmo as desmo_model

Params = dict[str, jnp.ndarray]
# the series contractions run at true fp32 like every other contraction of the
# training loss; without a precision XLA may round their operands to TF32
_HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class FourierSpec(desmo_model.DesmoSpec):
    n_fourier: int = 10
    period_init: float = 60.0


def t_points(m: int) -> np.ndarray:
    """``torch.linspace(0, m, m)`` — m points, endpoint included (:485)."""
    return np.linspace(0.0, float(m), m, dtype=np.float32)


def init_params(spec: FourierSpec, dtype=jnp.float32) -> Params:
    """All-ones coefficients, period_init periods (:517-543)."""
    T = spec.num_poly_terms
    ncoef = 2 * spec.n_fourier + 1
    return {
        "phi": jnp.ones((spec.r, spec.n), dtype),
        "c": jnp.ones((T,), dtype),
        "z": jnp.ones((T, ncoef), dtype),
        "period": jnp.full((T,), spec.period_init, dtype),
        "z_trig": jnp.ones((3, spec.r, ncoef), dtype),
        "trig_period": jnp.full((3, spec.r), spec.period_init, dtype),
        "c_trig": jnp.ones((3, spec.r), dtype),
        "omega": jnp.full((3, spec.r), spec.omega_init, dtype),
    }


def fourier_series_batch(
    coeffs: jnp.ndarray,  # (..., 2nF+1)  [a0, a1, b1, a2, b2, ...]
    period: jnp.ndarray,  # (...,)
    t: jnp.ndarray,  # (m,)
) -> jnp.ndarray:
    """Evaluate all channels' series at once: returns (..., m).

    Matches ``fourier_series`` (:487-506): a0 + sum a_n cos + b_n sin.
    """
    n_terms = (coeffs.shape[-1] - 1) // 2
    harmonics = jnp.arange(1, n_terms + 1, dtype=t.dtype)  # (nF,)
    # angle[..., k, j] = 2 pi (k+1) t_j / period[...]
    angle = (2.0 * jnp.pi) * harmonics[:, None] * t[None, :]  # (nF, m)
    angle = angle[None, ...] / period.reshape(-1)[:, None, None]  # (C, nF, m)
    flat = coeffs.reshape(-1, coeffs.shape[-1])  # (C, 2nF+1)
    a0 = flat[:, 0]
    a = flat[:, 1::2]  # (C, nF)
    b = flat[:, 2::2]
    out = (
        a0[:, None]
        + jnp.einsum("ck,ckm->cm", a, jnp.cos(angle), precision=_HIGHEST)
        + jnp.einsum("ck,ckm->cm", b, jnp.sin(angle), precision=_HIGHEST)
    )
    return out.reshape(*coeffs.shape[:-1], t.shape[0])


def period_candidates(
    x: np.ndarray,
    period_init: float,
    n_candidates: int = 4,
    pod_modes: np.ndarray | None = None,
    max_rows: int = 512,
) -> list[float]:
    """FFT-informed fundamental-period candidates for period multi-start.

    The reference hard-codes ``period_init`` per dataset
    (``DESMO_Fourier/cylinder_flow/DESMO-Cylinder.py:596-600``) because the
    learnable periods have a no-gradient basin: far from the data's true
    period the loss surface is flat in the period directions and training
    never migrates them (docs/RESULTS.md, round-3 notes). Mitigation (beyond
    reference): read the dominant temporal frequency off the data's power
    spectrum and probe a few fundamentals derived from it.

    Returns up to ``n_candidates`` periods in snapshot-index units, the
    preset's ``period_init`` first (so a short probe can only improve on the
    reference behavior), then ``mult / f_peak`` for mult = 1, 2, 3 — the peak
    may be any harmonic of the fundamental the series needs, and probing the
    small multiples covers that ambiguity at negligible cost.
    """
    if not np.isfinite(period_init):
        raise ValueError(f"period_init must be finite, got {period_init}")
    xa = np.asarray(x, np.float32)
    if pod_modes is not None:
        sig = np.asarray(pod_modes).T @ xa  # (r, m) temporal coefficients
    else:
        step = max(1, xa.shape[0] // max_rows)
        sig = xa[::step]
    sig = sig - sig.mean(axis=1, keepdims=True)
    power = np.abs(np.fft.rfft(sig, axis=1)) ** 2
    spectrum = power.sum(axis=0)
    spectrum[0] = 0.0  # DC
    k_peak = int(np.argmax(spectrum))
    # a non-positive period_init is not a usable candidate (the series maps
    # t -> 2*pi*t/period) — skip it rather than divide by zero below
    out = [float(period_init)] if period_init > 0.0 else []
    if k_peak > 0:
        m = xa.shape[1]
        base = float(m) / k_peak  # cycles of k_peak over the m-index window
        for mult in (1, 2, 3):
            c = base * mult
            if not any(abs(c - o) / o < 0.05 for o in out):
                out.append(c)
    return out[:n_candidates]


def temporal_values(params: Params, t: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Materialize z (T, m) and z_trig values (3, r, m) from the series."""
    z = fourier_series_batch(params["z"], params["period"], t)
    z_trig = fourier_series_batch(params["z_trig"], params["trig_period"], t)
    return z, z_trig


def apply(
    params: Params,
    pod_modes: jnp.ndarray,
    spec: FourierSpec,
    factors=None,
    t: jnp.ndarray | None = None,
    precision=jax.lax.Precision.HIGHEST,
):
    """Reconstruction; same contraction as plain DESMO once z's materialize."""
    if factors is None:
        factors = spec.factor_table()
    if t is None:
        t = jnp.asarray(t_points(spec.m))
    A, latent = desmo_model.spatial_dictionary(params, pod_modes, factors)
    z, z_trig = temporal_values(params, t)
    B = jnp.concatenate([z, z_trig.reshape(-1, z.shape[-1])], axis=0)
    recon = jnp.dot(A, B, precision=precision)
    return recon, latent, z


def build_loss(spec: FourierSpec, beta: float, l1_lambda: float, method: str = "factored"):
    """Same composite objective as plain DESMO (``...py:760-790``)."""
    from desmo_tpu import losses

    if method not in ("factored", "direct"):
        raise ValueError(f"fourier loss method {method!r}: use 'factored' or 'direct'")
    factors = spec.factor_table()
    t = jnp.asarray(t_points(spec.m))

    def loss_fn(params: Params, batch: dict):
        A, latent = desmo_model.spatial_dictionary(params, batch["pod_modes"], factors)
        z, z_trig = temporal_values(params, t)
        B = jnp.concatenate([z, z_trig.reshape(-1, z.shape[-1])], axis=0)
        if method == "factored":
            rec = losses.factored_mse(A, B, batch["x"], batch.get("x_sq"))
        else:
            rec = losses.mse(jnp.dot(A, B, precision=jax.lax.Precision.HIGHEST), batch["x"])
        ortho = losses.orthogonality(latent)
        l1 = losses.sparsity_l1(params)
        total = rec + beta * ortho + l1_lambda * l1
        return total, {"rec": rec, "ortho": ortho, "l1": l1}

    return loss_fn


param_groups = desmo_model.param_groups
