"""Autoencoder-latent DESMO: learned spatial modes instead of POD masks.

Reference: ``DESMO_AE/DESMO_Cylinder_AE-Final.py:629-768`` (``SINDyAutoencoder``
with ``Autoencoder_Linear_Temporal``). Each spatial point's full time series
(a row of X, length m) is encoded by an MLP m->256->128->64->16->8->4->2 with
ReLU, so the 2-dim latent per point forms two learned spatial modes phi1, phi2
(n, 2) — replacing POD initialization entirely; a symmetric decoder produces
an auxiliary reconstruction trained with an extra ``ae_beta * MSE`` term
(``...py:871``).

Reference quirks preserved deliberately (they define the shipped checkpoints):

* the tanh channel is computed but EXCLUDED from the reconstruction sum
  (commented out at ``...py:761``), so its parameters stay at init;
* tanh coefficients are also excluded from the L1 term (``...py:867-869``);
* per-channel omega inits differ: sin (1e4, 1e4), cos (1e3, 1e3),
  tanh (1e2, 1e2) for (phi1, phi2) (``...py:727-732``);
* the orthogonality loss is ``MSE(phi1 @ phi2^T, 0)`` over the full (n, n)
  outer product (``...py:861``) — algebraically
  ``||phi1||^2 ||phi2||^2 / n^2``, which is how we compute it (no (n, n)
  intermediate).

Parameters are a flat dict (MLP weights as ``ae_enc_w{i}/ae_enc_b{i}`` etc.,
(in, out)-oriented) so the packed-buffer trainer and sharding rules apply
unchanged. Weight init is Xavier-uniform/zero-bias like the reference
(distribution parity; bit parity with torch's RNG stream is out of scope).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from desmo_tpu import library
from desmo_tpu.models import desmo as desmo_model

Params = dict[str, jnp.ndarray]


ENCODER_WIDTHS = (256, 128, 64, 16, 8, 4)  # hidden layers; latent r follows


@dataclasses.dataclass(frozen=True)
class AESpec(desmo_model.DesmoSpec):
    """r=2, poly_order=2 in the reference run (``...py:775-777``)."""

    include_tanh: bool = False  # reference excludes tanh from the sum


def _xavier_uniform(key, fan_in: int, fan_out: int, dtype=jnp.float32):
    bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return jax.random.uniform(key, (fan_in, fan_out), dtype, -bound, bound)


def init_params(spec: AESpec, seed: int = 43, dtype=jnp.float32) -> Params:
    """MLP Xavier-uniform + zero biases; library params all-ones; omega inits
    per channel as in ``...py:710-732``. Seed 43 matches ``set_seed(43)``."""
    T = spec.num_poly_terms
    if spec.r != 2:
        raise ValueError("the AE variant is defined for r=2 latent modes")
    widths = (spec.m, *ENCODER_WIDTHS, spec.r)
    key = jax.random.PRNGKey(seed)
    params: Params = {}
    n_layers = len(widths) - 1
    keys = jax.random.split(key, 2 * n_layers)
    for i in range(n_layers):
        params[f"ae_enc_w{i}"] = _xavier_uniform(keys[i], widths[i], widths[i + 1], dtype)
        params[f"ae_enc_b{i}"] = jnp.zeros((widths[i + 1],), dtype)
    dec_widths = widths[::-1]
    for i in range(n_layers):
        params[f"ae_dec_w{i}"] = _xavier_uniform(
            keys[n_layers + i], dec_widths[i], dec_widths[i + 1], dtype
        )
        params[f"ae_dec_b{i}"] = jnp.zeros((dec_widths[i + 1],), dtype)
    params.update(
        {
            "c": jnp.ones((T,), dtype),
            "z": jnp.ones((T, spec.m), dtype),
            "z_trig": jnp.ones((3, spec.r, spec.m), dtype),
            "c_trig": jnp.ones((3, spec.r), dtype),
            # omega[k, i]: sin->1e4, cos->1e3, tanh->1e2 for both modes at the
            # reference's omega_init=1e4; the 1 : 0.1 : 0.01 channel ratio is
            # preserved for other omega_init values
            "omega": (spec.omega_init / 1e4)
            * jnp.asarray([[1e4, 1e4], [1e3, 1e3], [1e2, 1e2]], dtype),
        }
    )
    return params


def data_scaled_omega(params: Params, x_nm, ratio=(1.0, 0.1, 0.01)) -> jnp.ndarray:
    """Data-scaled omega init (one leg of the AE convergence recipe).

    The preset's literal channel inits (1e4/1e3/1e2, ``...py:727-732``) assume
    a particular latent scale; on O(1)-scaled data sin(1e4 x) over the
    encoder's latents is high-frequency noise. Scale-free version: keep the
    reference's 1 : 0.1 : 0.01 sin/cos/tanh ratio but set the sin arg scale
    from the *current latent RMS*, so omega * latent is O(1) in any data
    units. Enable with ``RunConfig.ae_omega_data_scaled`` / ``--ae-data-omega``
    (implied by the full ``ae_recipe``)."""
    latent, _ = encode_decode(params, x_nm)
    rms = jnp.sqrt(jnp.mean(latent * latent, axis=0))  # (r,)
    rms = jnp.maximum(rms, 1e-12)
    return jnp.asarray(ratio, latent.dtype)[:, None] / rms[None, :]


def init_params_live(spec: AESpec, seed: int = 43, bias: float = 0.01) -> Params:
    """He/ReLU-gain MLP init with small positive hidden biases — the init leg
    of the AE convergence recipe (``RunConfig.ae_recipe``).

    Why the reference init cannot train (measured, not hypothesized): with
    Xavier weights and ZERO biases through the deep narrowing funnel
    (m->256->...->2->...->m), the decoder's signal decays to ~1e-5 of the data
    RMS and some funnel layer's ReLUs output exactly zero for EVERY input —
    at that point the gradient w.r.t. every MLP weight is exactly 0.0 (only
    the last decoder bias receives gradient), so the auxiliary autoencoder
    can never leave its dead state; the torch reference shares this init and
    optimizer family, and ships no AE training log. He init preserves
    activation scale through ReLU layers; the +0.01 hidden biases keep units
    alive at small pre-activations."""
    params = init_params(spec, seed=seed)
    widths = (spec.m, *ENCODER_WIDTHS, spec.r)
    nl = len(widths) - 1
    key = jax.random.PRNGKey(seed + 1000)
    keys = jax.random.split(key, 2 * nl)
    for i in range(nl):
        params[f"ae_enc_w{i}"] = jax.random.normal(
            keys[i], (widths[i], widths[i + 1]), jnp.float32
        ) * float(np.sqrt(2.0 / widths[i]))
        if i < nl - 1:
            params[f"ae_enc_b{i}"] = jnp.full((widths[i + 1],), bias, jnp.float32)
    dw = widths[::-1]
    for i in range(nl):
        params[f"ae_dec_w{i}"] = jax.random.normal(
            keys[nl + i], (dw[i], dw[i + 1]), jnp.float32
        ) * float(np.sqrt(2.0 / dw[i]))
        if i < nl - 1:
            params[f"ae_dec_b{i}"] = jnp.full((dw[i + 1],), bias, jnp.float32)
    return params


def build_warmup_loss(spec: AESpec):
    """Autoencoder-only objective for the recipe's warmup phase: pure
    MSE(decode(encode(X)), X). Metrics keep the joint loss' key set so the
    chunked trainer/logger are oblivious to the phase. Dictionary params get
    zero gradient (frozen) during warmup."""
    from desmo_tpu import losses

    def loss_fn(params: Params, batch: dict):
        _latent, ae_rec = encode_decode(params, batch["x"])
        m = losses.mse(ae_rec, batch["x"])
        zero = jnp.zeros(())
        return m, {"rec": m, "ortho": zero, "l1": zero, "ae": m}

    return loss_fn


# Every AE contraction runs at true fp32. The dictionary evaluates
# sin(omega * latent) with omega up to 1e4 (preset), so a latent rounded to
# TF32 (10-bit mantissa; what Precision.HIGH gives on GPUs) shifts those
# arguments by O(1): the loss moves by ~5e-3 relative and the encoder's
# gradient loses all accuracy (~100% relative error against the float64
# reference, TF32 emulated at reduced n). The factored AE-MSE also cancels
# <H^T H, W W^T> against 2<H^T X, W> near convergence, which needs fp32 too.
_PRECISION = jax.lax.Precision.HIGHEST


def _mlp(params: Params, prefix: str, x: jnp.ndarray, n_layers: int) -> jnp.ndarray:
    for i in range(n_layers):
        x = jnp.dot(x, params[f"{prefix}_w{i}"], precision=_PRECISION)
        x = x + params[f"{prefix}_b{i}"]
        if i < n_layers - 1:
            x = jax.nn.relu(x)
    return x


def encode_decode(params: Params, x_nm: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(latent (n, r), ae reconstruction (n, m)) from point time series."""
    n_layers = len(ENCODER_WIDTHS) + 1
    latent = _mlp(params, "ae_enc", x_nm, n_layers)
    ae_rec = _mlp(params, "ae_dec", latent, n_layers)
    return latent, ae_rec


def _dictionary(params: Params, latent: jnp.ndarray, spec: AESpec, factors):
    theta = library.eval_library(latent, factors) * params["c"][None, :]
    basis = desmo_model.trig_basis(latent, params["omega"])  # (3, r, n)
    kind_mask = jnp.asarray([1.0, 1.0, 1.0 if spec.include_tanh else 0.0])
    g = (kind_mask[:, None, None] * params["c_trig"][:, :, None] * basis)
    g = g.reshape(-1, latent.shape[0]).T
    return jnp.concatenate([theta, g], axis=1)


def apply(
    params: Params,
    x_nm: jnp.ndarray,
    spec: AESpec,
    factors=None,
    precision=jax.lax.Precision.HIGHEST,
):
    """Returns (recon (n, m), latent (n, r), z (T, m), ae_rec (n, m))."""
    if factors is None:
        factors = spec.factor_table()
    latent, ae_rec = encode_decode(params, x_nm)
    A = _dictionary(params, latent, spec, factors)
    B = desmo_model.temporal_matrix(params)
    recon = jnp.dot(A, B, precision=precision)
    return recon, latent, params["z"], ae_rec


def frozen_latent_recon(params: Params, x_nm: jnp.ndarray, spec: AESpec):
    """``(latent, recon_fn)`` for the SR/forecast chain on a trained AE model.

    Encodes the TRAINING window once (the latent is a spatial map ``(n, r)``
    — the encoder consumes each point's m-length time series, so it is only
    defined on the window it was trained on) and returns a forward that
    rebuilds only the temporal side: ``recon_fn(p) = A(latent) @ B(p)``,
    where ``A`` is the dictionary on the frozen latent (reads ``p['c']`` /
    ``p['c_trig']`` so channel zeroing applies) and ``B`` the temporal
    matrix of ``p['z']`` / ``p['z_trig']`` — any column count, including a
    forecast horizon past the window. Consumed by ``runner.run(holdout=...)``
    via ``sr.forecast(recon_fn=...)``."""
    factors = spec.factor_table()
    latent, _ = encode_decode(params, jnp.asarray(x_nm))

    def recon_fn(p: Params) -> jnp.ndarray:
        A = _dictionary(p, latent, spec, factors)
        B = desmo_model.temporal_matrix(p)
        return jnp.dot(A, B, precision=jax.lax.Precision.HIGHEST)

    return latent, recon_fn


def ae_orthogonality(latent: jnp.ndarray) -> jnp.ndarray:
    """``MSE(phi1 @ phi2^T, 0) = ||phi1||^2 ||phi2||^2 / n^2`` (``...py:861``)."""
    n = latent.shape[0]
    s1 = jnp.sum(latent[:, 0] ** 2)
    s2 = jnp.sum(latent[:, 1] ** 2)
    return s1 * s2 / (n * n)


def ae_sparsity_l1(params: Params) -> jnp.ndarray:
    """|c| plus sin/cos coefficients only — tanh excluded (``...py:867-869``)."""
    return (
        jnp.sum(jnp.abs(params["c"]))
        + jnp.sum(jnp.abs(params["c_trig"][0]))
        + jnp.sum(jnp.abs(params["c_trig"][1]))
    )


def _factored_ae_mse(params: Params, latent: jnp.ndarray, x: jnp.ndarray, batch: dict) -> jnp.ndarray:
    """``MSE(decoder(latent), X)`` WITHOUT materializing the (n, m) decode.

    Factor the quadratic through the last decoder layer: with H the 256-wide
    last hidden activation, W/b the final layer, and 1 the all-ones row,

        ||H W + 1 b - X||^2 = <H^T H, W W^T> - 2 <H^T X, W>
                              + 2 (1^T H W) . b - 2 (1^T X) . b
                              + n ||b||^2 + ||X||^2

    — the same trick ``losses.factored_mse`` applies to the dictionary
    product (the reference materializes the decode,
    ``DESMO_AE/DESMO_Cylinder_AE-Final.py:859-860``). X is read once
    (``H^T X``) instead of three times (decode fwd + residual + backward).
    ``batch['x_colsum']``/``batch['x_sq']`` are used when precomputed
    (``runner.prepare_chunk_batch``) so no extra pass over X runs per step."""
    n_layers = len(ENCODER_WIDTHS) + 1
    h = latent
    for i in range(n_layers - 1):
        h = jax.nn.relu(
            jnp.dot(h, params[f"ae_dec_w{i}"], precision=_PRECISION) + params[f"ae_dec_b{i}"]
        )
    W = params[f"ae_dec_w{n_layers - 1}"]
    b = params[f"ae_dec_b{n_layers - 1}"]
    n, m = x.shape
    x_sq = batch.get("x_sq")
    if x_sq is None:
        x_sq = jnp.sum(x * x)
    xcol = batch.get("x_colsum")
    if xcol is None:
        xcol = jnp.sum(x, axis=0)
    hh = jnp.dot(h.T, h, precision=_PRECISION)
    ww = jnp.dot(W, W.T, precision=_PRECISION)
    hx = jnp.dot(h.T, x, precision=_PRECISION)
    sh = jnp.sum(h, axis=0)
    sq = (
        jnp.sum(hh * ww)
        - 2.0 * jnp.sum(hx * W)
        + x_sq
        + 2.0 * jnp.dot(jnp.dot(sh, W, precision=_PRECISION), b, precision=_PRECISION)
        - 2.0 * jnp.dot(xcol, b, precision=_PRECISION)
        + n * jnp.dot(b, b, precision=_PRECISION)
    )
    return sq / (n * m)


def build_loss(spec: AESpec, beta: float, l1_lambda: float, ae_beta: float, method: str = "factored"):
    """total = MSE + beta*ortho + l1_lambda*L1 + ae_beta*MSE(ae_rec, X)
    (``...py:859-871``). ``batch = {'x': X (n, m)[, 'x_sq', 'x_colsum']}``.
    'factored' (default) and 'direct' differ in the dictionary term exactly as
    in ``desmo.build_loss``; both factor the AE-MSE term (``_factored_ae_mse``).
    ``method='naive'`` also materializes the decode, for exact-parity runs."""
    from desmo_tpu import losses

    if method not in ("factored", "direct", "naive"):
        raise ValueError(
            f"ae loss method {method!r}: use 'factored', 'direct' or 'naive'"
        )
    factors = spec.factor_table()
    n_layers = len(ENCODER_WIDTHS) + 1

    def loss_fn(params: Params, batch: dict):
        x = batch["x"]
        latent = _mlp(params, "ae_enc", x, n_layers)
        A = _dictionary(params, latent, spec, factors)
        B = desmo_model.temporal_matrix(params)
        if method == "factored":
            rec = losses.factored_mse(A, B, x, batch.get("x_sq"))
        else:
            rec = losses.mse(jnp.dot(A, B, precision=jax.lax.Precision.HIGHEST), x)
        if method == "naive":
            ae = losses.mse(_mlp(params, "ae_dec", latent, n_layers), x)
        else:
            ae = _factored_ae_mse(params, latent, x, batch)
        ortho = ae_orthogonality(latent)
        l1 = ae_sparsity_l1(params)
        total = rec + beta * ortho + l1_lambda * l1 + ae_beta * ae
        return total, {"rec": rec, "ortho": ortho, "l1": l1, "ae": ae}

    return loss_fn


def param_group(key: str) -> str:
    """LR groups per ``...py:784-807``: omega -> 'omega' (lr 1e2 in the AE
    preset); every other parameter trains at 1e-2 (groups 'coef'/'z')."""
    if key == "omega":
        return "omega"
    if key in ("c", "c_trig"):
        return "coef"
    return "z"  # z, z_trig, and all AE MLP weights (default group, lr 1e-2)


def param_groups(params: Params) -> dict[str, str]:
    return {k: param_group(k) for k in params}


# --- reference state_dict interchange ---------------------------------------

_SCALAR_KEYS = {
    # state_dict name -> (params key, index)
    "sin_coef_1": ("c_trig", (0, 0)),
    "sin_coef_2": ("c_trig", (0, 1)),
    "cos_coef_1": ("c_trig", (1, 0)),
    "cos_coef_2": ("c_trig", (1, 1)),
    "tanh_coef_1": ("c_trig", (2, 0)),
    "tanh_coef_2": ("c_trig", (2, 1)),
    "omega_phi1": ("omega", (0, 0)),  # sin phi1 (...py:754)
    "omega_phi2": ("omega", (1, 0)),  # cos phi1 (:755)
    "omega_phi3": ("omega", (0, 1)),  # sin phi2 (:756)
    "omega_phi4": ("omega", (1, 1)),  # cos phi2 (:757)
    "omega_phi5": ("omega", (2, 0)),  # tanh phi1 (:758)
    "omega_phi6": ("omega", (2, 1)),  # tanh phi2 (:759)
}

_VECTOR_KEYS = {
    "zsin_coef_1": (0, 0),
    "zsin_coef_2": (0, 1),
    "zcos_coef_1": (1, 0),
    "zcos_coef_2": (1, 1),
    "ztanh_coef_1": (2, 0),
    "ztanh_coef_2": (2, 1),
}


def is_ae_state_dict(sd) -> bool:
    """True when the state dict carries the ``SINDyAutoencoder`` MLP keys."""
    return any(k.startswith("temporal_ae.") for k in sd)


def infer_spec_dims(sd) -> tuple[int, int]:
    """(r, poly_order) of an AE state dict — the read-and-infer counterpart
    of ``checkpoint.infer_spec_dims`` (which keys off ``phi_list.*``; AE
    checkpoints have no phi masks): r = latent width of the last encoder
    layer, poly_order recovered from ``len(c_coef)`` = C(r + P, P)."""
    last = 2 * len(ENCODER_WIDTHS)
    r = int(np.asarray(sd[f"temporal_ae.encoder.{last}.weight"]).shape[0])
    T = int(np.asarray(sd["c_coef"]).reshape(-1).shape[0])
    for P in range(1, 13):
        if library.num_poly_terms(r, P) == T:
            return r, P
    raise ValueError(f"no poly_order matches r={r}, len(c_coef)={T}")


def params_from_state_dict(sd) -> Params:
    """Import a reference ``SINDyAutoencoder`` state_dict.

    Torch Linear weights are (out, in); ours are (in, out) — transposed here.
    Sequential indices 0,2,4,... map to layer numbers (ReLUs hold no params).
    Every shape comes from the state dict itself (see ``infer_spec_dims``
    for recovering (r, poly_order)) — no spec needed.
    """
    params: Params = {}
    n_layers = len(ENCODER_WIDTHS) + 1
    for i in range(n_layers):
        params[f"ae_enc_w{i}"] = jnp.asarray(np.asarray(sd[f"temporal_ae.encoder.{2*i}.weight"]).T)
        params[f"ae_enc_b{i}"] = jnp.asarray(sd[f"temporal_ae.encoder.{2*i}.bias"])
        params[f"ae_dec_w{i}"] = jnp.asarray(np.asarray(sd[f"temporal_ae.decoder.{2*i}.weight"]).T)
        params[f"ae_dec_b{i}"] = jnp.asarray(sd[f"temporal_ae.decoder.{2*i}.bias"])
    params["c"] = jnp.asarray(sd["c_coef"])
    T = params["c"].shape[0]
    params["z"] = jnp.stack([jnp.asarray(sd[f"z_list.{t}"]) for t in range(T)])
    m = params["z"].shape[1]
    z_trig = np.ones((3, 2, m), np.float32)
    for name, (k, i) in _VECTOR_KEYS.items():
        z_trig[k, i] = np.asarray(sd[name])
    params["z_trig"] = jnp.asarray(z_trig)
    c_trig = np.ones((3, 2), np.float32)
    omega = np.ones((3, 2), np.float32)
    for name, (pk, idx) in _SCALAR_KEYS.items():
        target = c_trig if pk == "c_trig" else omega
        target[idx] = float(np.asarray(sd[name]))
    params["c_trig"] = jnp.asarray(c_trig)
    params["omega"] = jnp.asarray(omega)
    return params


def state_dict_from_params(params: Params) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    n_layers = len(ENCODER_WIDTHS) + 1
    for i in range(n_layers):
        sd[f"temporal_ae.encoder.{2*i}.weight"] = np.asarray(params[f"ae_enc_w{i}"]).T
        sd[f"temporal_ae.encoder.{2*i}.bias"] = np.asarray(params[f"ae_enc_b{i}"])
        sd[f"temporal_ae.decoder.{2*i}.weight"] = np.asarray(params[f"ae_dec_w{i}"]).T
        sd[f"temporal_ae.decoder.{2*i}.bias"] = np.asarray(params[f"ae_dec_b{i}"])
    sd["c_coef"] = np.asarray(params["c"])
    for t in range(params["z"].shape[0]):
        sd[f"z_list.{t}"] = np.asarray(params["z"][t])
    for name, (k, i) in _VECTOR_KEYS.items():
        sd[name] = np.asarray(params["z_trig"][k, i])
    for name, (pk, idx) in _SCALAR_KEYS.items():
        src = params["c_trig"] if pk == "c_trig" else params["omega"]
        sd[name] = np.asarray(src[idx])
    return sd
