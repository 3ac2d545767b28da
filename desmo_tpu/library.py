"""Candidate-term library for DESMO, represented as *data*, not control flow.

The reference (``DESMO/cylinder_flow/DESMO-Cylinder.py:376-434``, ``POOL_DATA``)
builds the polynomial library column-by-column with nested Python loops and one
``torch.cat`` per term — ~35 sequential kernel launches per forward pass.
Here we instead precompute, once at trace time, an integer *factor table*
``F (num_terms, poly_order)`` indexing into the augmented mode matrix
``[1, phi_1, ..., phi_r]``; the whole library is then a single fused
gather + product that XLA folds into the reconstruction GEMM's prologue.

Term ordering is bit-identical to the reference's loop nest (degree-ascending,
and within each degree the ``i <= j <= k`` lexicographic order, which equals
``itertools.combinations_with_replacement``), so coefficient vectors and
temporal-coefficient stacks indexed by term line up 1:1 with the shipped
PyTorch checkpoints (`SURVEY.md` §2.4, §2.11).
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

__all__ = [
    "num_poly_terms",
    "monomial_exponents",
    "factor_table",
    "eval_library",
    "poly_term_names",
    "trig_term_names",
    "TRIG_KINDS",
]

# Order of the nonlinear ("fourier") channels everywhere in the framework.
# Matches the reference's omega_list layout: omega_list[3*i + k] is the
# frequency of kind k for mode i (CYL:561-563).
TRIG_KINDS: tuple[str, str, str] = ("sin", "cos", "tanh")


def num_poly_terms(n_vars: int, poly_order: int) -> int:
    """Number of monomials in r variables up to total degree ``poly_order``.

    Equals ``sum_{k=0..P} C(n_vars + k - 1, k)`` — the closed form printed by
    the reference (``CYL:448-455``, ``calculate_number_of_terms``).
    """
    return sum(math.comb(n_vars + k - 1, k) for k in range(poly_order + 1))


@lru_cache(maxsize=None)
def _term_tuples(n_vars: int, poly_order: int) -> tuple[tuple[int, ...], ...]:
    """All monomials as tuples of variable indices, reference ordering."""
    terms: list[tuple[int, ...]] = []
    for degree in range(poly_order + 1):
        terms.extend(itertools.combinations_with_replacement(range(n_vars), degree))
    return tuple(terms)


def monomial_exponents(n_vars: int, poly_order: int) -> np.ndarray:
    """Exponent matrix ``E (num_terms, n_vars)``: term t = prod_i phi_i**E[t,i]."""
    terms = _term_tuples(n_vars, poly_order)
    E = np.zeros((len(terms), n_vars), dtype=np.int32)
    for t, tup in enumerate(terms):
        for v in tup:
            E[t, v] += 1
    return E


def factor_table(n_vars: int, poly_order: int) -> np.ndarray:
    """Factor-index table ``F (num_terms, poly_order)`` into ``[1, phi_1..phi_r]``.

    Index 0 is the constant-one column; index i+1 is mode i. Degree-d terms are
    padded with zeros so every term is a product of exactly ``poly_order``
    gathered columns. Using gathers instead of ``phi ** E`` keeps the gradient
    well-defined when a mode value is exactly zero (x**0 has a NaN power-rule
    cotangent at x=0).
    """
    if poly_order < 1:
        raise ValueError("poly_order must be >= 1")
    terms = _term_tuples(n_vars, poly_order)
    F = np.zeros((len(terms), poly_order), dtype=np.int32)
    for t, tup in enumerate(terms):
        for p, v in enumerate(tup):
            F[t, p] = v + 1
    return F


def eval_library(phi: jnp.ndarray, factors: np.ndarray | jnp.ndarray) -> jnp.ndarray:
    """Evaluate the polynomial library: ``phi (n, r)`` -> ``theta (n, T)``.

    One gather producing ``(n, T, P)`` followed by a product over P — a single
    fused elementwise kernel under XLA (vs. the reference's per-term cat loop,
    ``CYL:376-434``).
    """
    ones = jnp.ones((phi.shape[0], 1), dtype=phi.dtype)
    aug = jnp.concatenate([ones, phi], axis=1)  # (n, r+1)
    gathered = aug[:, factors]  # (n, T, P)
    return jnp.prod(gathered, axis=-1)


def poly_term_names(n_vars: int, poly_order: int, var: str = "phi") -> list[str]:
    """Human-readable names per polynomial term, reference ordering.

    Mirrors ``generate_c_coef_terms`` (``DESMO/turbulent_channel/
    DESMO-TurbulentChannel.py:1252-1266``): '1', 'phi1', 'phi1^2', 'phi1*phi2', ...
    """
    names = []
    for tup in _term_tuples(n_vars, poly_order):
        if not tup:
            names.append("1")
            continue
        parts = []
        for v, grp in itertools.groupby(tup):
            count = len(list(grp))
            base = f"{var}{v + 1}"
            parts.append(base if count == 1 else f"{base}^{count}")
        names.append("*".join(parts))
    return names


def trig_term_names(n_vars: int, var: str = "phi") -> list[str]:
    """Names of the 3r nonlinear terms, in (kind-major, mode) storage order."""
    return [f"{kind}({var}{i + 1})" for kind in TRIG_KINDS for i in range(n_vars)]


def ref_interleaved_trig_names(n_vars: int, var: str = "phi") -> list[str]:
    """Nonlinear-term names in the reference's interleaved (mode-major) order,

    i.e. the order of ``nonlinear_norm``'s output: sin(phi1), cos(phi1),
    tanh(phi1), sin(phi2), ... (``CYL:653-692``)."""
    return [f"{kind}({var}{i + 1})" for i in range(n_vars) for kind in TRIG_KINDS]
