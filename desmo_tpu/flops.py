"""Per-step FLOP counts derived from shapes, for throughput reporting.

``useful`` is the number of floating-point operations (2 per multiply-add)
of the contractions one optimizer step needs, at the true sizes (n, m and
K = T + 3r dictionary terms), each logical contraction counted once.
Element-wise work (the dictionary build, the trig terms, Adamax) is not
counted. A rate is ``useful * steps_per_sec``; dividing it by a device's
peak is left to the benchmark, which knows the device it measured.
"""

from __future__ import annotations

from desmo_tpu import library


def dictionary_step_flops(n: int, m: int, r: int, poly_order: int) -> dict:
    """FLOPs of one step of the factored dictionary loss
    (``losses.factored_mse``), desmo or fourier variant: forward
    ``ga = A^T A``, ``gb = B B^T`` and ``ax = A^T X``; backward
    ``dA = (2/nm)(A gb - X B^T)`` and ``dB = (2/nm)(ga B - ax)``. The two X
    contractions (``ax`` and ``X B^T``) are the only ones of size n*m*K."""
    T = library.num_poly_terms(r, poly_order)
    K = T + 3 * r
    useful = 2 * (
        n * m * K  # ax = A^T X
        + n * m * K  # X B^T
        + n * K * K  # ga = A^T A
        + n * K * K  # A gb
        + K * K * m  # gb = B B^T
        + K * K * m  # ga B
    )
    return {"useful": useful, "K": K}


def ae_step_flops(n: int, m: int, r: int, poly_order: int, encoder_widths=None) -> dict:
    """FLOPs of one AE optimizer step: the m->256->...->r encoder and
    mirrored decoder GEMMs over n rows (forward + backward ~ 3x forward),
    plus the dictionary contraction set on the (n, r) latent."""
    if encoder_widths is None:
        from desmo_tpu.models.autoencoder import ENCODER_WIDTHS

        encoder_widths = ENCODER_WIDTHS
    widths = (m, *encoder_widths, r)
    per_row = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    mlp_fwd = 2 * n * per_row * 2  # encoder + mirrored decoder
    mlp = 3 * mlp_fwd  # forward + dL/dW + dL/dx
    dictionary = dictionary_step_flops(n, m, r, poly_order)
    return {"useful": mlp + dictionary["useful"], "K": dictionary["K"]}


def step_flops(cfg) -> dict:
    """Dispatch on preset variant. ``cfg`` is a ``configs`` preset."""
    if cfg.variant == "ae":
        return ae_step_flops(cfg.n, cfg.m, cfg.r, cfg.poly_order)
    return dictionary_step_flops(cfg.n, cfg.m, cfg.r, cfg.poly_order)
