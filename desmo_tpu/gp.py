"""Self-contained genetic-programming symbolic regression: the DESMO-SR
discovery leg (reference: PySR + Julia) with NO external engine.

The reference's DESMO-SR script fits dz/dt = f(z) by genetic symbolic
regression (`DESMO-SR/cylinder_flow/DESMO-Cylinder-ReadAndInference-
DynamicalSystemsFit.py:1118-1134`: PySRRegressor with +,-,*,/ binary ops,
sin unary, nesting/complexity constraints, squared-error loss) and then
selects equations from the per-target hall-of-fame tables by score
(`...py:1191-1226`). PySR needs Julia, which this framework treats as
optional (`sr.fit_pysr` stays behind its import gate). This module provides
the same contract natively so `engine='gp'` works everywhere:

- expression trees over the SAME operator set and constraints as the
  reference config: binary +, -, *, / ; unary sin; no sin nested inside sin
  (`nested_constraints={"sin": {"sin": 0}}`); per-argument complexity caps
  `{add: 10, mul: 10, sin: 5}`;
- squared-error loss, complexity = node count (PySR's convention);
- a hall of fame per target keeping the best expression at each complexity,
  reduced to its Pareto front, with PySR's score
  `(log loss_prev - log loss_i) / (c_i - c_prev)` between successive front
  rows (the first row scores against the best-constant baseline so a
  single-row table still ranks);
- deterministic, seeded evolution (tournament selection, subtree crossover,
  point/subtree mutation, constant jitter) + Nelder-Mead constant polish on
  Pareto improvements;
- output: per-target ``sr.EquationCandidate`` tables that feed the existing
  ``sr.select_equations`` -> ``sr.lambdify_system`` -> ``sr.simulate``
  pipeline unchanged.

This is host-side tooling, like the reference's (PySR runs on CPU/Julia
there) — the device training path is untouched; numpy vectorizes each node op
over the (m,) trajectory so a full fit is seconds at reference sizes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

# --- expression trees -------------------------------------------------------
# A node is a nested tuple: ("var", i) | ("const", float) |
# ("sin", child) | (op, left, right) with op in BINOPS.

BINOPS = ("+", "-", "*", "/")
# reference constraints (...py:1120-1134): per-argument max complexity under
# these operators; "-" and "/" are unconstrained there, as here
ARG_CAPS = {"+": 10, "*": 10, "sin": 5}


def complexity(node) -> int:
    """Node count — PySR's complexity convention (each op and leaf is 1)."""
    tag = node[0]
    if tag in ("var", "const"):
        return 1
    if tag == "sin":
        return 1 + complexity(node[1])
    return 1 + complexity(node[1]) + complexity(node[2])


def _contains_sin(node) -> bool:
    tag = node[0]
    if tag in ("var", "const"):
        return False
    if tag == "sin":
        return True
    return _contains_sin(node[1]) or _contains_sin(node[2])


def check_constraints(node, max_complexity: int) -> bool:
    """Reference constraint set: total complexity cap, per-argument caps
    under + / * / sin, and no sin anywhere inside sin."""
    if complexity(node) > max_complexity:
        return False

    def rec(nd):
        tag = nd[0]
        if tag in ("var", "const"):
            return True
        if tag == "sin":
            child = nd[1]
            if _contains_sin(child) or complexity(child) > ARG_CAPS["sin"]:
                return False
            return rec(child)
        l, r = nd[1], nd[2]
        cap = ARG_CAPS.get(tag)
        if cap is not None and (complexity(l) > cap or complexity(r) > cap):
            return False
        return rec(l) and rec(r)

    return rec(node)


def evaluate(node, Z: np.ndarray) -> np.ndarray:
    """Vectorized evaluation over the (m, k) channel matrix -> (m,). Raw
    division like PySR — a non-finite result simply earns an inf loss."""
    tag = node[0]
    if tag == "var":
        return Z[:, node[1]]
    if tag == "const":
        return np.full(Z.shape[0], node[1])
    if tag == "sin":
        return np.sin(evaluate(node[1], Z))
    l = evaluate(node[1], Z)
    r = evaluate(node[2], Z)
    with np.errstate(all="ignore"):
        if tag == "+":
            return l + r
        if tag == "-":
            return l - r
        if tag == "*":
            return l * r
        return l / r


def to_str(node, names: Sequence[str]) -> str:
    """sympy-parseable infix string (fully parenthesized)."""
    tag = node[0]
    if tag == "var":
        return names[node[1]]
    if tag == "const":
        return f"{node[1]:.10g}"
    if tag == "sin":
        return f"sin({to_str(node[1], names)})"
    return f"({to_str(node[1], names)} {tag} {to_str(node[2], names)})"


def fold_constants(node):
    """Light simplification: collapse all-constant subtrees so the emitted
    equations read like PySR's (e.g. (2 * 3) -> 6); exact arithmetic only."""
    tag = node[0]
    if tag in ("var", "const"):
        return node
    if tag == "sin":
        c = fold_constants(node[1])
        if c[0] == "const":
            return ("const", float(math.sin(c[1])))
        return ("sin", c)
    l = fold_constants(node[1])
    r = fold_constants(node[2])
    if l[0] == "const" and r[0] == "const":
        with np.errstate(all="ignore"):
            v = evaluate((tag, l, r), np.zeros((1, 1)))[0]
        if np.isfinite(v):
            return ("const", float(v))
    return (tag, l, r)


def _constants(node, path=()):
    """Yield (path, value) for every constant leaf (for the polish step)."""
    tag = node[0]
    if tag == "const":
        yield path, node[1]
    elif tag == "sin":
        yield from _constants(node[1], path + (1,))
    elif tag not in ("var",):
        yield from _constants(node[1], path + (1,))
        yield from _constants(node[2], path + (2,))


def _replace(node, path, value):
    if not path:
        return ("const", float(value)) if node[0] == "const" else node
    i = path[0]
    parts = list(node)
    parts[i] = _replace(parts[i], path[1:], value)
    return tuple(parts)


def _set_constants(node, paths, values):
    for p, v in zip(paths, values):
        node = _replace(node, p, v)
    return node


# --- random generation / variation ------------------------------------------


def _rand_leaf(rng: np.random.Generator, k: int, const_scale: float):
    if rng.random() < 0.6:
        return ("var", int(rng.integers(k)))
    return ("const", float(rng.normal(0.0, const_scale)))


def _rand_tree(rng, k, depth, const_scale):
    if depth <= 0 or rng.random() < 0.25:
        return _rand_leaf(rng, k, const_scale)
    if rng.random() < 0.2:
        return ("sin", _rand_tree(rng, k, depth - 1, const_scale))
    op = BINOPS[int(rng.integers(len(BINOPS)))]
    return (
        op,
        _rand_tree(rng, k, depth - 1, const_scale),
        _rand_tree(rng, k, depth - 1, const_scale),
    )


def _subtrees(node, path=()):
    yield path, node
    tag = node[0]
    if tag == "sin":
        yield from _subtrees(node[1], path + (1,))
    elif tag in BINOPS:
        yield from _subtrees(node[1], path + (1,))
        yield from _subtrees(node[2], path + (2,))


def _replace_subtree(node, path, new):
    if not path:
        return new
    parts = list(node)
    parts[path[0]] = _replace_subtree(parts[path[0]], path[1:], new)
    return tuple(parts)


def _crossover(rng, a, b):
    pa = list(_subtrees(a))
    pb = list(_subtrees(b))
    path, _ = pa[int(rng.integers(len(pa)))]
    _, donor = pb[int(rng.integers(len(pb)))]
    return _replace_subtree(a, path, donor)


def _mutate(rng, node, k, const_scale):
    roll = rng.random()
    spots = list(_subtrees(node))
    path, sub = spots[int(rng.integers(len(spots)))]
    if roll < 0.3:  # point mutation
        tag = sub[0]
        if tag == "const":
            new = ("const", float(sub[1] + rng.normal(0.0, 0.3 * (abs(sub[1]) + 0.1))))
        elif tag == "var":
            new = ("var", int(rng.integers(k)))
        elif tag in BINOPS:
            new = (BINOPS[int(rng.integers(len(BINOPS)))], sub[1], sub[2])
        else:  # sin -> keep; jitter inside instead
            new = sub
        return _replace_subtree(node, path, new)
    if roll < 0.55:  # subtree replacement
        return _replace_subtree(node, path, _rand_tree(rng, k, 2, const_scale))
    if roll < 0.75:  # hoist: replace the whole tree by one of its subtrees
        return sub
    if roll < 0.9:  # grow: wrap a subtree in a new op
        if rng.random() < 0.25 and not _contains_sin(sub):
            return _replace_subtree(node, path, ("sin", sub))
        op = BINOPS[int(rng.integers(len(BINOPS)))]
        leaf = _rand_leaf(rng, k, const_scale)
        pair = (sub, leaf) if rng.random() < 0.5 else (leaf, sub)
        return _replace_subtree(node, path, (op, *pair))
    # constant jitter everywhere
    out = node
    for p, v in _constants(node):
        out = _replace(out, p, v + rng.normal(0.0, 0.1 * (abs(v) + 0.1)))
    return out


# --- fitness / hall of fame ---------------------------------------------------


def _loss(node, Z, y) -> float:
    with np.errstate(all="ignore"):
        pred = evaluate(node, Z)
        err = pred - y
        val = float(np.mean(err * err))
    return val if math.isfinite(val) else float("inf")


def _polish_constants(node, Z, y, maxiter=200):
    """Nelder-Mead on the tree's constant leaves (PySR optimizes constants
    with BFGS per mutation; one polish per Pareto improvement suffices here)."""
    consts = list(_constants(node))
    if not consts or len(consts) > 6:
        return node
    paths = [p for p, _ in consts]
    x0 = np.array([v for _, v in consts], float)

    def obj(x):
        return _loss(_set_constants(node, paths, x), Z, y)

    try:
        from scipy.optimize import minimize

        res = minimize(obj, x0, method="Nelder-Mead",
                       options={"maxiter": maxiter, "fatol": 1e-12})
        if math.isfinite(res.fun) and res.fun < obj(x0):
            return _set_constants(node, paths, res.x)
    except Exception:
        pass
    return node


def _pareto_table(hof: dict, baseline_loss: float, names):
    """PySR-style table: Pareto front over (complexity, loss) with
    score = (log loss_prev - log loss_i) / (c_i - c_prev); the first row
    scores against the best-constant baseline (slight extension of PySR,
    which zeroes the first row — this keeps single-row tables rankable)."""
    from desmo_tpu.sr import EquationCandidate

    rows = sorted(hof.items())  # (complexity, (loss, tree))
    front = []
    best = float("inf")
    for c, (loss, tree) in rows:
        if loss < best:
            front.append((c, loss, tree))
            best = loss
    out = []
    prev_c, prev_l = 0, max(baseline_loss, 1e-300)
    for c, loss, tree in front:
        dl = math.log(prev_l) - math.log(max(loss, 1e-300))
        score = dl / max(c - prev_c, 1)
        out.append(
            EquationCandidate(
                equation=to_str(fold_constants(tree), names),
                score=float(score),
                complexity=int(c),
                loss=float(loss),
            )
        )
        prev_c, prev_l = c, max(loss, 1e-300)
    return out


@dataclasses.dataclass
class GPConfig:
    niterations: int = 60  # generations
    population_size: int = 300
    max_complexity: int = 25
    tournament_k: int = 4
    p_crossover: float = 0.5
    seed: int = 0
    early_stop_loss: float = 1e-12  # relative to target variance


def fit_gp(
    z: np.ndarray,
    dzdt: np.ndarray,
    variable_names: Optional[Sequence[str]] = None,
    log: Optional[Callable[[str], None]] = None,
    **overrides,
):
    """Fit dz/dt = f(z) per target column; return per-target candidate tables
    (list of lists of ``sr.EquationCandidate``) ready for
    ``sr.select_equations``. Deterministic for a given seed."""
    cfg = GPConfig(**overrides)
    Z = np.asarray(z, np.float64)
    Y = np.asarray(dzdt, np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    m, k = Z.shape
    names = list(variable_names) if variable_names else [f"z{i}" for i in range(k)]
    const_scale = float(np.std(Z)) or 1.0
    tables = []
    for j in range(Y.shape[1]):
        y = Y[:, j]
        rng = np.random.default_rng(cfg.seed * 1000 + j)
        baseline = float(np.var(y)) or 1e-30
        stop_at = cfg.early_stop_loss * baseline

        # seeded population: constants, single vars, c*var pairs, then random
        pop = [("const", float(np.mean(y)))]
        pop += [("var", i) for i in range(k)]
        pop += [("*", ("const", float(rng.normal(0, 1))), ("var", i)) for i in range(k)]
        while len(pop) < cfg.population_size:
            t = _rand_tree(rng, k, 3, const_scale)
            if check_constraints(t, cfg.max_complexity):
                pop.append(t)
        losses = [_loss(t, Z, y) for t in pop]

        hof: dict = {}

        def offer(tree, loss):
            c = complexity(tree)
            cur = hof.get(c)
            if cur is None or loss < cur[0]:
                # Pareto improvement: polish constants once, then record
                better = _polish_constants(tree, Z, y)
                bl = _loss(better, Z, y) if better is not tree else loss
                if bl < loss:
                    tree, loss = better, bl
                prev = hof.get(complexity(tree))
                if prev is None or loss < prev[0]:
                    hof[complexity(tree)] = (loss, tree)
                return True
            return False

        for t, l in zip(pop, losses):
            if math.isfinite(l):
                offer(t, l)

        for gen in range(cfg.niterations):
            newpop, newloss = [], []
            # elitism: keep the current Pareto front in the population
            front = sorted(hof.items())
            best = float("inf")
            for c, (l, t) in front:
                if l < best:
                    newpop.append(t)
                    newloss.append(l)
                    best = l
            rejects = 0
            while len(newpop) < cfg.population_size:
                def pick():
                    idx = rng.integers(len(pop), size=cfg.tournament_k)
                    # lexicographic: loss, then complexity (parsimony)
                    return pop[min(
                        idx, key=lambda i: (losses[i], complexity(pop[i]))
                    )]

                if rejects > 10 * cfg.population_size:
                    # safety valve: refill with fresh leaves rather than spin
                    child = _rand_leaf(rng, k, const_scale)
                elif rng.random() < cfg.p_crossover:
                    child = _crossover(rng, pick(), pick())
                else:
                    child = _mutate(rng, pick(), k, const_scale)
                if not check_constraints(child, cfg.max_complexity):
                    rejects += 1
                    continue
                l = _loss(child, Z, y)
                if not math.isfinite(l):
                    rejects += 1
                    continue
                newpop.append(child)
                newloss.append(l)
                offer(child, l)
            pop, losses = newpop, newloss
            best_loss = min(v[0] for v in hof.values())
            if log is not None and (gen % 10 == 0 or gen == cfg.niterations - 1):
                log(f"gp target {j}: gen {gen}, best loss {best_loss:.3e}")
            if best_loss <= stop_at:
                break
        tables.append(_pareto_table(hof, baseline, names))
    return tables
