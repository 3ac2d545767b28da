"""Float64 NumPy reference of the training losses and their gradients.

The plain reference the factored JAX losses are checked against: the DIRECT
objective of each variant, with the (n, m) reconstruction materialized
exactly as the reference scripts compute it
(``DESMO/cylinder_flow/DESMO-Cylinder.py:713-733``; AE
``DESMO_AE/DESMO_Cylinder_AE-Final.py:859-871``), and its gradient by
hand-written reverse mode. It imports no JAX, so no matmul precision setting
can reach it. ``loss_and_grad`` takes the same flat parameter dict the models
use and returns ``(total, {key: dtotal/dkey})`` in float64.
"""

from __future__ import annotations

import numpy as np

from desmo_tpu import library

_ENCODER_LAYERS = 7  # m -> 256 -> 128 -> 64 -> 16 -> 8 -> 4 -> r


def _library(latent: np.ndarray, factors: np.ndarray):
    """theta (n, T) and the gathered factors (n, T, P) of the polynomial
    library over ``[1, latent]`` (``library.eval_library``)."""
    aug = np.concatenate([np.ones((latent.shape[0], 1)), latent], axis=1)
    gathered = aug[:, factors]
    return gathered.prod(axis=-1), gathered


def _library_grad(dtheta: np.ndarray, gathered: np.ndarray, factors: np.ndarray, r: int):
    """d latent (n, r) from d theta (n, T)."""
    P = factors.shape[1]
    daug = np.zeros((dtheta.shape[0], r + 1))
    for p in range(P):
        others = np.prod(np.delete(gathered, p, axis=2), axis=2)
        onehot = np.eye(r + 1)[factors[:, p]]  # (T, r + 1)
        daug += (dtheta * others) @ onehot
    return daug[:, 1:]


def _trig(latent, omega, c_trig, kind_mask):
    """Trig dictionary columns (n, 3r), kind-major like the models."""
    args = omega[:, :, None] * latent.T[None, :, :]  # (3, r, n)
    f = np.stack([np.sin(args[0]), np.cos(args[1]), np.tanh(args[2])])
    g = kind_mask[:, None, None] * c_trig[:, :, None] * f
    return g.reshape(-1, latent.shape[0]).T, args, f


def _trig_grad(dG, latent, omega, c_trig, kind_mask, args, f):
    """(d latent (n, r), d c_trig (3, r), d omega (3, r)) from dG (n, 3r)."""
    r, n = latent.shape[1], latent.shape[0]
    dg = dG.T.reshape(3, r, n) * kind_mask[:, None, None]
    dc_trig = np.sum(dg * f, axis=2)
    df = dg * c_trig[:, :, None]
    dargs = np.stack([
        df[0] * np.cos(args[0]),
        -df[1] * np.sin(args[1]),
        df[2] * (1.0 - np.tanh(args[2]) ** 2),
    ])
    domega = np.sum(dargs * latent.T[None, :, :], axis=2)
    dlatent = np.sum(dargs * omega[:, :, None], axis=0).T
    return dlatent, dc_trig, domega


def _dictionary(p, latent, factors, kind_mask):
    theta, gathered = _library(latent, factors)
    G, args, f = _trig(latent, p["omega"], p["c_trig"], kind_mask)
    A = np.concatenate([theta * p["c"][None, :], G], axis=1)
    return A, (theta, gathered, args, f)


def _dictionary_grad(dA, p, latent, factors, kind_mask, saved):
    """(d latent, grads of c / c_trig / omega) from dA (n, T + 3r)."""
    theta, gathered, args, f = saved
    T = theta.shape[1]
    grads = {"c": np.sum(dA[:, :T] * theta, axis=0)}
    dlatent = _library_grad(dA[:, :T] * p["c"][None, :], gathered, factors, latent.shape[1])
    dl_trig, grads["c_trig"], grads["omega"] = _trig_grad(
        dA[:, T:], latent, p["omega"], p["c_trig"], kind_mask, args, f
    )
    return dlatent + dl_trig, grads


def _series(coeffs, period, t):
    """Fourier series values (C, m) of flattened channels and the pieces of
    their gradient (``models/fourier.fourier_series_batch``)."""
    nf = (coeffs.shape[-1] - 1) // 2
    c = coeffs.reshape(-1, coeffs.shape[-1])
    angle = (2.0 * np.pi) * np.arange(1, nf + 1)[None, :, None] * t[None, None, :]
    angle = angle / period.reshape(-1)[:, None, None]  # (C, nF, m)
    cos, sin = np.cos(angle), np.sin(angle)
    a, b = c[:, 1::2], c[:, 2::2]
    z = c[:, :1] + np.einsum("ck,ckm->cm", a, cos) + np.einsum("ck,ckm->cm", b, sin)
    return z, (c, angle, cos, sin, a, b)


def _series_grad(dz, period, saved, coeff_shape):
    c, angle, cos, sin, a, b = saved
    dc = np.zeros_like(c)
    dc[:, 0] = dz.sum(axis=1)
    dc[:, 1::2] = np.einsum("cm,ckm->ck", dz, cos)
    dc[:, 2::2] = np.einsum("cm,ckm->ck", dz, sin)
    dangle = dz[:, None, :] * (-a[:, :, None] * sin + b[:, :, None] * cos)
    dperiod = np.sum(dangle * (-angle), axis=(1, 2)) / period.reshape(-1)
    return dc.reshape(coeff_shape), dperiod.reshape(period.shape)


def _mlp(p, prefix, x):
    acts = [x]
    for i in range(_ENCODER_LAYERS):
        h = acts[-1] @ p[f"{prefix}_w{i}"] + p[f"{prefix}_b{i}"]
        acts.append(np.maximum(h, 0.0) if i < _ENCODER_LAYERS - 1 else h)
    return acts


def _mlp_grad(dout, p, prefix, acts, grads):
    """Accumulate weight/bias grads into ``grads``; return d input."""
    d = dout
    for i in reversed(range(_ENCODER_LAYERS)):
        if i < _ENCODER_LAYERS - 1:
            d = d * (acts[i + 1] > 0.0)
        grads[f"{prefix}_w{i}"] = acts[i].T @ d
        grads[f"{prefix}_b{i}"] = d.sum(axis=0)
        d = d @ p[f"{prefix}_w{i}"].T
    return d


def loss_and_grad(
    variant: str,
    params: dict,
    x: np.ndarray,
    *,
    r: int,
    poly_order: int,
    beta: float,
    l1_lambda: float,
    ae_beta: float = 0.0,
    pod_modes: np.ndarray | None = None,
    t: np.ndarray | None = None,
    include_tanh: bool = False,
) -> tuple[float, dict]:
    """Direct objective and its gradient in float64.

    desmo/fourier: ``MSE(A B, X) + beta * ortho + l1_lambda * L1`` with POD
    masked modes (``pod_modes`` (n, r)); fourier evaluates B from its series
    at times ``t``. ae: the encoder latent replaces the masked modes, the tanh
    channel is masked out of the sum unless ``include_tanh``, and
    ``ae_beta * MSE(decode(latent), X)`` is added (``models/autoencoder``)."""
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    X = np.asarray(x, np.float64)
    n, m = X.shape
    factors = library.factor_table(r, poly_order)
    grads: dict = {}
    if variant == "ae":
        kind_mask = np.array([1.0, 1.0, 1.0 if include_tanh else 0.0])
        enc = _mlp(p, "ae_enc", X)
        latent = enc[-1]
    else:
        kind_mask = np.ones(3)
        pod = np.asarray(pod_modes, np.float64)
        latent = pod * p["phi"].T
    A, saved = _dictionary(p, latent, factors, kind_mask)
    if variant == "fourier":
        t = np.asarray(t, np.float64)
        z, z_saved = _series(p["z"], p["period"], t)
        zt, zt_saved = _series(p["z_trig"], p["trig_period"], t)
        B = np.concatenate([z, zt], axis=0)
    else:
        B = np.concatenate([p["z"], p["z_trig"].reshape(-1, m)], axis=0)

    R = A @ B - X
    rec = np.mean(R * R)
    dR = (2.0 / R.size) * R
    dA, dB = dR @ B.T, A.T @ dR
    dlatent, dict_grads = _dictionary_grad(dA, p, latent, factors, kind_mask, saved)
    grads.update(dict_grads)

    T = factors.shape[0]
    if variant == "fourier":
        grads["z"], grads["period"] = _series_grad(dB[:T], p["period"], z_saved, p["z"].shape)
        grads["z_trig"], grads["trig_period"] = _series_grad(
            dB[T:], p["trig_period"], zt_saved, p["z_trig"].shape
        )
    else:
        grads["z"] = dB[:T]
        grads["z_trig"] = dB[T:].reshape(p["z_trig"].shape)

    if variant == "ae":
        s1, s2 = np.sum(latent[:, 0] ** 2), np.sum(latent[:, 1] ** 2)
        ortho = s1 * s2 / (n * n)
        dlatent = dlatent + beta * np.stack(
            [2.0 * latent[:, 0] * s2, 2.0 * latent[:, 1] * s1], axis=1
        ) / (n * n)
        l1 = np.sum(np.abs(p["c"])) + np.sum(np.abs(p["c_trig"][:2]))
        grads["c"] = grads["c"] + l1_lambda * np.sign(p["c"])
        grads["c_trig"] = grads["c_trig"] + l1_lambda * np.sign(p["c_trig"]) * np.array(
            [[1.0], [1.0], [0.0]]
        )
        dec = _mlp(p, "ae_dec", latent)
        E = dec[-1] - X
        ae = np.mean(E * E)
        dlatent = dlatent + _mlp_grad(ae_beta * (2.0 / E.size) * E, p, "ae_dec", dec, grads)
        _mlp_grad(dlatent, p, "ae_enc", enc, grads)
        total = rec + beta * ortho + l1_lambda * l1 + ae_beta * ae
    else:
        gram = latent.T @ latent
        upper = np.triu(np.ones((r, r)), k=1)
        ortho = np.sum(upper * np.abs(gram))
        S = upper * np.sign(gram)
        dlatent = dlatent + beta * latent @ (S + S.T)
        l1 = np.sum(np.abs(p["c"])) + np.sum(np.abs(p["c_trig"]))
        grads["c"] = grads["c"] + l1_lambda * np.sign(p["c"])
        grads["c_trig"] = grads["c_trig"] + l1_lambda * np.sign(p["c_trig"])
        grads["phi"] = (dlatent * pod).T
        total = rec + beta * ortho + l1_lambda * l1
    return float(total), {k: grads[k] for k in params}
