"""Lane-packed multi-seed (ensemble / multi-start) DESMO training.

NEW CAPABILITY beyond the reference (which hard-codes one deterministic
all-ones init per dataset, ``DESMO/cylinder_flow/DESMO-Cylinder.py:506-530``,
and can only multi-start by re-running the whole script): train S
independently-initialized DESMO models SIMULTANEOUSLY for roughly the cost
of ONE, then keep the best.

Packing: S seeds' dictionaries sit side by side in one wide matrix, so every
contraction of the training step runs once for all seeds:

    A_packed (n, S*K)   = [A_seed0 | A_seed1 | ...]   (block-column)
    B_packed (S*K, m)   = [B_seed0 ; B_seed1 ; ...]   (block-row)

* ``X B^T``, ``A^T X``, ``A^T A``, ``dA = A gb`` run as one wider GEMM each;
  only the BLOCK-DIAGONAL of the packed Grams is used, so per-seed objectives
  stay exactly independent.
* X is shared: one read serves all S seeds.
* Adamax runs over one flat packed buffer (seed-major group LRs); the
  ReduceLROnPlateau scheduler is vmapped over seeds, each driven by its own
  total loss — every seed follows exactly the trajectory it would follow
  alone (asserted vs. independent single-seed runs in
  ``tests/test_ensemble.py``).

Capacity: S*K <= ``PACK_WIDTH`` columns per compiled group — 4 seeds for the
r=4/P=2 presets (K=27), 2 seeds for cylinder r=4/P=3 (K=47). The packed Grams
are (S*K)^2 of which only S*K^2 is used, so the wasted Gram work grows with S;
larger S runs as several packed groups in sequence (``max_seeds_packed``).
The width is not tuned on the GPU yet (ROADMAP A6).

The same packing carries a HYPERPARAMETER multi-start (``resolve_hypers``):
per-seed beta/l1_lambda weight each seed's own ortho/L1 terms and an
lr_scale multiplies each seed's LR row, so a (beta, lambda, lr) combo grid
trains in one packed run. The winner is then picked by REC error —
per-seed totals weight ortho/L1 differently and are not comparable.

Scope: the desmo variant (POD-masked modes) and the Fourier variant — the
spatial dictionary packs identically; the per-seed temporal series evaluate
batched over the seed axis, and per-seed PERIODS turn the FFT-informed period
multi-start (``fourier.period_candidates``) into S simultaneous candidates
trained to completion instead of sequential short probes
(``runner.fourier_period_multistart``). The AE variant's cost is
MLP-dominated and is not packed.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from desmo_tpu import checkpoint, library, optim, train
from desmo_tpu.configs import GROUP_ORDER, RunConfig
from desmo_tpu.models import desmo as desmo_model
from desmo_tpu.models import fourier as fourier_model

PACK_WIDTH = 128


def max_seeds_packed(spec) -> int:
    """How many seeds fit in one ``PACK_WIDTH``-column pack for this
    architecture."""
    K = spec.num_poly_terms + 3 * spec.r
    return max(1, PACK_WIDTH // K)


def resolve_hypers(cfg: RunConfig, n_seeds: int, warn: bool = True):
    """Per-seed hyperparameters from the cfg sweep lists, or ``None``.

    HYPERPARAMETER MULTI-START (beyond reference — the reference hard-codes
    one (beta, lambda, lr) setting per dataset and can only sweep by
    re-running the whole script): the packed ensemble trains every seed under
    its OWN loss weights / LR scale in one run, because beta and lambda weight
    each seed's own terms and the LRs were per-seed rows already.

    ``cfg.sweep_beta`` / ``cfg.sweep_lam`` / ``cfg.sweep_lr_scale`` are value
    lists; their CARTESIAN PRODUCT forms the combo grid and seed s takes
    ``combos[s % len(combos)]`` — so n_seeds == len(combos) gives one seed per
    combo, and n_seeds = k*len(combos) gives k differently-initialized seeds
    per combo. Empty lists contribute the cfg's own value (a single point).

    Returns ``None`` when no sweep is configured (every list empty or
    single-valued at the cfg default), else a dict with per-seed float32
    arrays ``betas``, ``lams``, ``lr_scales`` (length n_seeds) and the combo
    grid ``combos`` for logging.
    """
    bl = tuple(float(v) for v in (getattr(cfg, "sweep_beta", ()) or (cfg.beta,)))
    ll = tuple(float(v) for v in (getattr(cfg, "sweep_lam", ()) or (cfg.l1_lambda,)))
    sl = tuple(float(v) for v in (getattr(cfg, "sweep_lr_scale", ()) or (1.0,)))
    if bl == (float(cfg.beta),) and ll == (float(cfg.l1_lambda),) and sl == (1.0,):
        return None
    import itertools

    combos = list(itertools.product(bl, ll, sl))
    take = [combos[s % len(combos)] for s in range(n_seeds)]
    if warn and len(combos) > n_seeds:
        import warnings

        warnings.warn(
            f"{len(combos)} hyperparameter combos but only {n_seeds} seeds — "
            f"combos beyond the first {n_seeds} will not be trained; raise "
            "--seeds to cover the full grid",
            stacklevel=2,
        )
    return {
        "betas": np.asarray([c[0] for c in take], np.float32),
        "lams": np.asarray([c[1] for c in take], np.float32),
        "lr_scales": np.asarray([c[2] for c in take], np.float32),
        "combos": combos,
    }


def packed_factor_table(spec, n_seeds: int) -> np.ndarray:
    """Seed-blocked factor table into ``[1, lat(0,0)..lat(0,r-1), lat(1,0)..]``.

    Index 0 stays the shared constant-one column; seed s's mode i lives at
    column ``1 + s*r + i`` of the augmented latent matrix.
    """
    F = spec.factor_table()  # (T, P), 0 = ones column, i+1 = mode i
    blocks = [np.where(F > 0, F + s * spec.r, 0) for s in range(n_seeds)]
    return np.concatenate(blocks, axis=0)  # (S*T, P)


def init_params(
    spec,
    n_seeds: int,
    seed: int = 0,
    phi_sigma: float = 0.02,
    omega_spread: float = 0.0,
    periods=None,
) -> dict:
    """Per-seed DESMO/DESMOFourier params with a leading seed axis on every key.

    Seed 0 is EXACTLY the reference init (all ones, omega = omega_init) so
    the ensemble always contains the reference trajectory; seeds 1.. jitter
    phi multiplicatively (1 + sigma*N(0,1)) and omega log-uniformly within
    ``10**[-omega_spread, +omega_spread]``. A ``FourierSpec`` gets the
    Fourier init (series coefficients + periods); ``periods`` (optional,
    fourier only) assigns seed s the candidate ``periods[s % len(periods)]``
    as its period/trig_period init — pass the preset's ``period_init`` first
    so seed 0 stays the reference trajectory.
    """
    is_fourier = hasattr(spec, "n_fourier")
    base = (fourier_model if is_fourier else desmo_model).init_params(spec)
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    stacked = {k: jnp.broadcast_to(v, (n_seeds, *v.shape)) for k, v in base.items()}
    if n_seeds > 1 and phi_sigma > 0.0:
        noise = phi_sigma * jax.random.normal(
            keys[0], (n_seeds - 1, spec.r, spec.n), jnp.float32
        )
        phi = jnp.concatenate([stacked["phi"][:1], stacked["phi"][1:] * (1.0 + noise)])
        stacked = dict(stacked, phi=phi)
    if n_seeds > 1 and omega_spread > 0.0:
        fac = 10.0 ** jax.random.uniform(
            keys[1], (n_seeds - 1, 3, spec.r), jnp.float32,
            minval=-omega_spread, maxval=omega_spread,
        )
        om = jnp.concatenate([stacked["omega"][:1], stacked["omega"][1:] * fac])
        stacked = dict(stacked, omega=om)
    if periods is not None and len(periods) > 0:
        if not is_fourier:
            raise ValueError("periods only applies to the fourier variant")
        pv = jnp.asarray(
            [float(periods[s % len(periods)]) for s in range(n_seeds)], jnp.float32
        )
        stacked = dict(
            stacked,
            period=jnp.broadcast_to(pv[:, None], stacked["period"].shape),
            trig_period=jnp.broadcast_to(
                pv[:, None, None], stacked["trig_period"].shape
            ),
        )
    return stacked


def extract_seed(params: dict, s: int) -> dict:
    """Standard single-seed desmo params of ensemble member ``s`` — directly
    compatible with checkpoint/sparsify/viz/evaluate."""
    return {k: v[s] for k, v in params.items()}


def packed_dictionary(params: dict, pod_modes: jnp.ndarray, spec, factors_packed):
    """Packed spatial dictionary ``A (n, S*K)`` + per-seed latents ``(S, n, r)``.

    Column layout per seed block: [T polynomial terms, 3r trig terms] —
    the SAME order as the single-seed dictionary, so block s of A against
    block s of B reproduces ``desmo.spatial_dictionary`` exactly.
    """
    S = params["phi"].shape[0]
    n = pod_modes.shape[0]
    # latents: (S, n, r); packed view (n, S*r) feeds the polynomial gather
    latents = pod_modes[None, :, :] * jnp.transpose(params["phi"], (0, 2, 1))
    lat_packed = jnp.transpose(latents, (1, 0, 2)).reshape(n, S * spec.r)
    theta = library.eval_library(lat_packed, factors_packed)  # (n, S*T)
    theta = theta.reshape(n, S, spec.num_poly_terms) * params["c"][None, :, :]
    # trig: (S, 3, r, n) elementwise over all seeds at once
    args = params["omega"][:, :, :, None] * jnp.transpose(latents, (0, 2, 1))[:, None, :, :]
    basis = jnp.stack(
        [jnp.sin(args[:, 0]), jnp.cos(args[:, 1]), jnp.tanh(args[:, 2])], axis=1
    )  # (S, 3, r, n)
    g = params["c_trig"][:, :, :, None] * basis
    g = jnp.transpose(g.reshape(S, 3 * spec.r, n), (2, 0, 1))  # (n, S, 3r)
    A = jnp.concatenate([theta, g], axis=2).reshape(n, -1)  # (n, S*K)
    return A, latents


def packed_temporal(params: dict) -> jnp.ndarray:
    """``B (S*K, m)`` block-rows matching ``packed_dictionary``'s columns."""
    S, _, m = params["z"].shape
    z_trig = params["z_trig"].reshape(S, -1, m)
    return jnp.concatenate([params["z"], z_trig], axis=1).reshape(-1, m)


def packed_temporal_fourier(params: dict, t: jnp.ndarray) -> jnp.ndarray:
    """Fourier ``B (S*K, m)``: every seed's series (own coefficients AND own
    periods) evaluates in one batched pass — ``fourier_series_batch`` flattens
    all leading axes, so the seed axis rides along for free."""
    S = params["z"].shape[0]
    z = fourier_model.fourier_series_batch(params["z"], params["period"], t)
    zt = fourier_model.fourier_series_batch(
        params["z_trig"], params["trig_period"], t
    )
    m = z.shape[-1]
    return jnp.concatenate([z, zt.reshape(S, -1, m)], axis=1).reshape(-1, m)


def factored_mse_blocks(
    a: jnp.ndarray,
    b: jnp.ndarray,
    x: jnp.ndarray,
    x_sq: Optional[jnp.ndarray],
    n_seeds: int,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Per-seed ``mean((A_s B_s - X)^2)`` -> (S,), from ONE set of packed dots.

    Only the block-diagonal of the packed Grams ``A^T A`` / ``B B^T`` enters
    the per-seed objectives, so gradients stay seed-independent (off-diagonal
    blocks get zero cotangent); the cross term ``<A_s^T X, B_s>`` is summed
    per seed block.
    """
    S = n_seeds
    K = a.shape[1] // S
    m = b.shape[1]
    ga = jnp.dot(a.T, a, precision=precision)
    gb = jnp.dot(b, b.T, precision=precision)
    ax = jnp.dot(a.T, x, precision=precision)
    if x_sq is None:
        x_sq = jnp.sum(x * x)
    idx = jnp.arange(S)
    ga_d = ga.reshape(S, K, S, K)[idx, :, idx, :]
    gb_d = gb.reshape(S, K, S, K)[idx, :, idx, :]
    cross = jnp.sum((ax * b).reshape(S, K, m), axis=(1, 2))
    return (jnp.sum(ga_d * gb_d, axis=(1, 2)) - 2.0 * cross + x_sq) / (x.shape[0] * m)


def build_loss(
    spec, cfg: RunConfig, n_seeds: int, betas=None, lams=None,
) -> Callable:
    """Packed multi-seed loss: ``(params, batch) -> (sum_s total_s, metrics)``.

    Per-seed params are disjoint, so ``grad(sum_s total_s)`` IS the stacked
    per-seed gradient. Metrics carry (S,) vectors: rec/ortho/l1/total. The
    reconstruction term is the factored form (``factored_mse_blocks``).
    ``betas``/``lams`` (optional, length n_seeds) weight each seed's ortho/L1
    terms individually (hyperparameter multi-start, ``resolve_hypers``).
    """
    factors_packed = packed_factor_table(spec, n_seeds)
    is_fourier = getattr(cfg, "variant", "desmo") == "fourier"
    t = jnp.asarray(fourier_model.t_points(spec.m)) if is_fourier else None
    beta_s = (
        float(cfg.beta) if betas is None else jnp.asarray(betas, jnp.float32)
    )
    lam_s = (
        float(cfg.l1_lambda) if lams is None else jnp.asarray(lams, jnp.float32)
    )

    def loss_fn(params: dict, batch: dict):
        A, latents = packed_dictionary(params, batch["pod_modes"], spec, factors_packed)
        B = packed_temporal_fourier(params, t) if is_fourier else packed_temporal(params)
        rec = factored_mse_blocks(A, B, batch["x"], batch.get("x_sq"), n_seeds)
        # per-seed orthogonality: |off-diagonal latent Gram|, upper triangle
        gram = jnp.einsum(
            "sni,snj->sij", latents, latents, precision=jax.lax.Precision.HIGHEST
        )
        iu = jnp.triu(jnp.ones((spec.r, spec.r), dtype=bool), k=1)
        ortho = jnp.sum(jnp.where(iu[None], jnp.abs(gram), 0.0), axis=(1, 2))
        l1 = jnp.sum(jnp.abs(params["c"]), axis=1) + jnp.sum(
            jnp.abs(params["c_trig"]), axis=(1, 2)
        )
        total_s = rec + beta_s * ortho + lam_s * l1
        metrics = {"rec": rec, "ortho": ortho, "l1": l1, "total_s": total_s}
        return jnp.sum(total_s), metrics

    return loss_fn


class _SeedFlatLayout:
    """Packed-buffer layout with SEED-MAJOR group LRs.

    Same packing as ``train._FlatLayout`` but every element's LR index is
    ``seed * len(GROUP_ORDER) + group`` into the raveled (S, G) scheduler LR
    matrix — each seed's plateau scheduler steers only its own slice.
    """

    def __init__(self, params: dict, group_of: dict[str, str], n_seeds: int):
        self.keys = list(params)
        self.shapes = {k: tuple(np.shape(params[k])) for k in self.keys}
        self.n_seeds = n_seeds
        G = len(GROUP_ORDER)
        sizes = {k: int(np.prod(self.shapes[k])) for k in self.keys}
        self.offsets = {}
        off = 0
        for k in self.keys:
            self.offsets[k] = off
            off += sizes[k]
        self.total = off
        gidx = np.empty(off, np.int32)
        for k in self.keys:
            shape = self.shapes[k]
            assert shape[0] == n_seeds, f"{k}: missing seed axis"
            per_seed = sizes[k] // n_seeds
            g = GROUP_ORDER.index(group_of[k])
            block = np.repeat(np.arange(n_seeds, dtype=np.int32) * G + g, per_seed)
            gidx[self.offsets[k] : self.offsets[k] + sizes[k]] = block
        self.group_index = gidx

    def flatten(self, tree: dict) -> jnp.ndarray:
        return jnp.concatenate(
            [jnp.ravel(tree[k]).astype(jnp.float32) for k in self.keys]
        )

    def unflatten(self, vec: jnp.ndarray) -> dict:
        out = {}
        for k in self.keys:
            size = int(np.prod(self.shapes[k]))
            out[k] = jax.lax.dynamic_slice_in_dim(
                vec, self.offsets[k], size
            ).reshape(self.shapes[k])
        return out


def init_state(
    params: dict, cfg: RunConfig, n_seeds: int, lr_scales=None
) -> train.TrainState:
    """TrainState whose scheduler carries per-seed LR rows (S, G).

    ``lr_scales`` (optional, length n_seeds) multiplies seed s's whole LR row
    by ``lr_scales[s]`` — the LR leg of the hyperparameter multi-start (the
    per-seed rows then evolve independently under each seed's own plateau
    scheduler, exactly as uniform rows do)."""
    lrs = jnp.broadcast_to(
        jnp.asarray(cfg.group_lrs, jnp.float32), (n_seeds, len(GROUP_ORDER))
    )
    if lr_scales is not None:
        scales = jnp.asarray(lr_scales, jnp.float32)
        if scales.shape != (n_seeds,):
            raise ValueError(
                f"lr_scales must have shape ({n_seeds},), got {scales.shape}"
            )
        lrs = lrs * scales[:, None]
    sched = optim.PlateauState(
        lrs=lrs,
        best=jnp.full((n_seeds,), jnp.inf, jnp.float32),
        num_bad=jnp.zeros((n_seeds,), jnp.int32),
    )
    return train.TrainState(
        params=params,
        opt=optim.adamax_init(params),
        sched=sched,
        epoch=jnp.zeros((), jnp.int32),
    )


def make_ensemble_chunk(
    loss_fn, group_of: dict[str, str], cfg: RunConfig, n_seeds: int,
    param_shardings: Optional[dict] = None,
):
    """Jitted scan of packed multi-seed epochs — ``train.make_train_chunk``'s
    packed fast path with (a) seed-major per-element LRs and (b) a vmapped
    per-seed ReduceLROnPlateau driven by each seed's own total loss.

    ``param_shardings`` (key -> ``NamedSharding``, from
    ``parallel.ensemble_param_shardings``) makes the loop sharding-aware the
    same way ``train.make_train_chunk`` is: leaves whose spec splits a mesh
    axis (phi rows over 'space') are carried per-leaf through the scan and
    pinned each iteration so their params AND Adamax moments stay distributed
    — packed multi-start composes with the device mesh (seeds in the term axis,
    space over devices). Replicated leaves keep the packed fast path."""
    G = len(GROUP_ORDER)
    b1, b2, eps = 0.9, 0.999, 1e-8
    sharded_sh = {
        k: s for k, s in (param_shardings or {}).items() if train._is_sharded(s)
    }

    vplateau = jax.vmap(
        lambda st, m: optim.plateau_step(
            st, m, patience=cfg.patience, factor=cfg.sched_factor,
            min_lr=cfg.sched_min_lr,
        )
    )

    def chunk_impl(state: train.TrainState, batch: dict, num_steps: int):
        packed_keys = [k for k in state.params if k not in sharded_sh]
        layout = _SeedFlatLayout(
            {k: state.params[k] for k in packed_keys}, group_of, n_seeds
        )
        gidx = jnp.asarray(layout.group_index)
        # sharded leaves: one per-SEED LR column each (lrs is (S, G))
        sh_g = {k: GROUP_ORDER.index(group_of[k]) for k in sharded_sh}

        def pin(tree: dict) -> dict:
            return {
                k: jax.lax.with_sharding_constraint(v, sharded_sh[k])
                for k, v in tree.items()
            }

        def full_loss(vec, sh_params, batch):
            params = layout.unflatten(vec)
            params.update(sh_params)
            return loss_fn(params, batch)

        def body(carry, _):
            vec, mu, nu, sh_p, sh_mu, sh_nu, count, sched, epoch = carry
            sh_p = pin(sh_p)
            (total, metrics), (g, g_sh) = jax.value_and_grad(
                full_loss, argnums=(0, 1), has_aux=True
            )(vec, sh_p, batch)
            g_sh = pin(g_sh)
            count = count + 1
            bias = 1.0 - b1 ** count.astype(jnp.float32)
            mu = b1 * mu + (1.0 - b1) * g
            nu = jnp.maximum(b2 * nu, jnp.abs(g) + eps)
            lr_elem = sched.lrs.ravel()[gidx]
            vec = vec - (lr_elem / bias) * mu / nu
            sh_mu = pin({k: b1 * sh_mu[k] + (1.0 - b1) * g_sh[k] for k in sh_mu})
            sh_nu = pin(
                {
                    k: jnp.maximum(b2 * sh_nu[k], jnp.abs(g_sh[k]) + eps)
                    for k in sh_nu
                }
            )
            sh_p = pin(
                {
                    k: sh_p[k]
                    - (
                        sched.lrs[:, sh_g[k]].reshape(
                            (-1,) + (1,) * (sh_p[k].ndim - 1)
                        )
                        / bias
                    )
                    * sh_mu[k] / sh_nu[k]
                    for k in sh_p
                }
            )
            stepped = vplateau(sched, metrics["total_s"])
            do_sched = epoch % cfg.sched_every == 0
            sched = jax.tree.map(
                lambda a, b: jnp.where(do_sched, a, b), stepped, sched
            )
            metrics = dict(metrics)
            metrics["total"] = total
            return (vec, mu, nu, sh_p, sh_mu, sh_nu, count, sched, epoch + 1), metrics

        carry = (
            layout.flatten({k: state.params[k] for k in packed_keys}),
            layout.flatten({k: state.opt.mu[k] for k in packed_keys}),
            layout.flatten({k: state.opt.nu[k] for k in packed_keys}),
            {k: state.params[k] for k in sharded_sh},
            {k: state.opt.mu[k] for k in sharded_sh},
            {k: state.opt.nu[k] for k in sharded_sh},
            state.opt.count,
            state.sched,
            state.epoch,
        )
        (vec, mu, nu, sh_p, sh_mu, sh_nu, count, sched, epoch), metrics = jax.lax.scan(
            body, carry, None, length=num_steps,
            unroll=min(getattr(cfg, "scan_unroll", 1), num_steps),
        )

        def rebuild(vec, sh_tree):
            out = layout.unflatten(vec)
            out.update(sh_tree)
            return {k: out[k] for k in state.params}  # original key order

        out_state = train.TrainState(
            params=rebuild(vec, sh_p),
            opt=optim.AdamaxState(count, rebuild(mu, sh_mu), rebuild(nu, sh_nu)),
            sched=sched,
            epoch=epoch,
        )
        return out_state, metrics

    return jax.jit(chunk_impl, static_argnames=("num_steps",), donate_argnames=("state",))


def term_stability(
    seed_params: Sequence[dict], spec, threshold: float = 1.0
) -> dict:
    """Cross-seed TERM-STABILITY report (beyond reference): which candidate
    terms survive sparsification in EVERY multi-start member vs which are
    init-sensitive artifacts.

    DESMO's whole point is an interpretable sparse dictionary — but the
    reference trains exactly one init per dataset, so a term's presence in
    its final table may be an accident of the init rather than structure in
    the data. With S trained members (from one packed ensemble run),
    selection frequency across seeds separates the two: frequency 1.0 under
    the reference's energy threshold = a robust term, fractional frequency =
    init-dependent.

    ``seed_params``: the LIVE members' single-seed param dicts
    (``extract_seed`` / ``fit``'s ``report['seed_params']``). Energies use
    the reference's convention (``sparsify.term_energies``, raw phi masks).
    Returns names (poly + interleaved trig, reference order), the (S,
    n_terms) energy matrix, per-term selection ``frequency`` at ``threshold``
    plus energy mean/std across seeds.
    """
    from desmo_tpu import sparsify

    rows = []
    for p in seed_params:
        e = sparsify.term_energies(p, spec=spec)
        rows.append(np.concatenate([np.asarray(e.poly), e.interleaved_trig()]))
    E = np.stack(rows)  # (S, T + 3r)
    names = library.poly_term_names(spec.r, spec.poly_order) + (
        library.ref_interleaved_trig_names(spec.r)
    )
    sel = E >= threshold
    return {
        "names": names,
        "energies": E,
        "threshold": float(threshold),
        "frequency": sel.mean(axis=0),
        "mean": E.mean(axis=0),
        "std": E.std(axis=0),
    }


def seed_state(state: train.TrainState, cfg: RunConfig, s: int) -> train.TrainState:
    """Single-seed ``TrainState`` view of ensemble member ``s`` — resumable by
    the standard scanned chunk (same layouts, same semantics)."""
    return train.TrainState(
        params=extract_seed(state.params, s),
        opt=optim.AdamaxState(
            count=state.opt.count,
            mu=extract_seed(state.opt.mu, s),
            nu=extract_seed(state.opt.nu, s),
        ),
        sched=optim.PlateauState(
            lrs=state.sched.lrs[s],
            best=state.sched.best[s],
            num_bad=state.sched.num_bad[s],
        ),
        epoch=state.epoch,
    )


def _restore_with_frozen(snap, frozen: np.ndarray) -> train.TrainState:
    """Rebuild a fresh TrainState from the chunk-boundary snapshot,
    NEUTRALIZING the seeds marked in ``frozen``.

    A frozen seed must not be able to contaminate the pack again, so it is
    dropped in place, not merely paused: params are zeroed (periods set to
    1.0 — a zero period would put ``2*pi/period = inf`` right back into the
    series), moments reset (nu to 1.0, never 0: the Adamax update divides by
    it), the LR row goes to 0, and the plateau counter to a large negative
    value so a later plateau trigger cannot clamp the row back up to
    ``sched_min_lr`` (``optim.plateau_step`` clamps reduced LRs at min_lr,
    which would silently unfreeze an lr=0 row). Zero params are always
    finite-loss: the latents vanish, so the dictionary reduces to constants
    and the seed's rec loss pins at ``mean(X^2)``. Everything runs as device
    ops on the (device-resident) snapshot — no host round trip."""
    fz = jnp.asarray(frozen)

    def _mask(v, fill):
        m = fz.reshape((-1,) + (1,) * (v.ndim - 1))
        return jnp.where(m, jnp.asarray(fill, v.dtype), v)

    sched = optim.PlateauState(
        lrs=_mask(snap.sched.lrs, 0.0),
        best=jnp.asarray(snap.sched.best),
        num_bad=_mask(snap.sched.num_bad, -(2**30)),
    )
    return train.TrainState(
        params={
            k: _mask(v, 1.0 if "period" in k else 0.0)
            for k, v in snap.params.items()
        },
        opt=optim.AdamaxState(
            count=jnp.asarray(snap.opt.count),
            mu={k: _mask(v, 0.0) for k, v in snap.opt.mu.items()},
            nu={k: _mask(v, 1.0) for k, v in snap.opt.nu.items()},
        ),
        sched=sched,
        epoch=jnp.asarray(snap.epoch),
    )


def fit(
    cfg: RunConfig,
    spec,
    batch: dict,
    n_seeds: int,
    num_epochs: Optional[int] = None,
    seed: int = 0,
    phi_sigma: float = 0.02,
    omega_spread: float = 0.0,
    log: Optional[Callable[[str], None]] = print,
    checkpoint_fn: Optional[Callable] = None,
    max_recoveries: int = 8,
    device_mesh=None,
    hypers: Optional[dict] = None,
    report: Optional[dict] = None,
) -> tuple[train.TrainResult, int, np.ndarray]:
    """Train an S-seed packed ensemble; returns ``(result, best, final_totals)``
    where ``result.state`` is the BEST member's single-seed TrainState.

    ``hypers`` (default: ``resolve_hypers(cfg, n_seeds)``) activates the
    HYPERPARAMETER MULTI-START: per-seed ``betas``/``lams`` weight each seed's
    own terms and ``lr_scales`` scales each seed's LR row, so S (beta,
    lambda, lr) settings train in one packed run.
    Under a sweep the winning seed is chosen by final REC error, not total —
    per-seed totals weight ortho/L1 differently and are not comparable
    (``final_totals`` still reports each seed's own total).

    ``report``, when a dict is passed, is filled with per-seed diagnostics:
    ``hypers`` (the resolved grid actually used, or None), ``final_recs``
    (each seed's last-step rec loss, inf for frozen seeds — the cross-seed
    comparable numbers a hyper sweep is judged by), and ``seed_params`` /
    ``live_seeds`` (every NON-diverged member's single-seed param dict with
    its global seed index — the input to ``term_stability``; params only,
    not the whole TrainState, so the report doesn't pin the Adamax moments
    of every member in device memory — ``seed_state`` rebuilds a resumable
    state from the returned packed ``result.state`` when one is needed).

    Seeds beyond ``max_seeds_packed(spec)`` run in additional packed groups
    sequentially; compiled chunks are CACHED per pack width, so groups of the
    same size share one compile.

    Failure containment (beyond the single-seed abort): a diverged seed does
    NOT kill the ensemble. Its non-finite params would contaminate every
    seed's gradients through the packed contractions within one step
    (``NaN * 0 = NaN`` in the Gram backward), so on a non-finite per-seed
    total the chunk is rolled back to the last healthy boundary snapshot, the
    ORIGINATING seeds (non-finite at the first bad step, before contamination
    spreads) are frozen (LR 0, reported final total = inf, excluded from
    best-seed selection), and the chunk re-runs. Only when every seed has
    diverged (or after ``max_recoveries`` rollbacks) does fit raise.

    ``checkpoint_fn(state, epoch)``, when given, is called at every chunk
    boundary with the current group's best live seed as a single-seed
    TrainState — a crash mid-run loses at most ``cfg.checkpoint_every``
    epochs, same contract as ``train.fit``. Graceful preemption
    (``train.request_preemption`` / the SIGTERM handler) is honored at the
    same boundaries: the current group stops after its in-flight chunk (the
    per-chunk checkpoint above already saved the best live seed), later
    groups are skipped, and the result carries ``preempted=True`` with the
    best seed among those trained.

    ``device_mesh`` (a ('space','time') ``jax.sharding.Mesh``) composes
    multi-start with multi-device: seeds stay packed in the term axis while
    each seed's phi rows (and Adamax moments) shard over 'space', through the
    sharding-aware packed scan chunk (``parallel.ensemble_param_shardings``).
    """
    if hypers is None:
        hypers = resolve_hypers(cfg, n_seeds)
    if report is not None:
        # provenance: the hypers fit ACTUALLY used (resolved or explicit),
        # so callers persist the real grid instead of re-deriving it
        report["hypers"] = hypers
    if hypers is not None and log is not None:
        log(
            f"[ensemble] hyperparameter multi-start: {len(hypers['combos'])} "
            "(beta, l1_lambda, lr_scale) combos, seed s takes combo "
            f"s mod {len(hypers['combos'])}: {hypers['combos']}"
        )
    num_epochs = cfg.num_epochs if num_epochs is None else num_epochs
    if num_epochs <= 0:
        # no trained metric exists to pick a best seed from (train.fit's
        # zero-epoch no-op contract has no multi-seed analogue)
        raise ValueError(f"ensemble.fit needs num_epochs > 0, got {num_epochs}")
    cap = max_seeds_packed(spec)
    is_fourier = getattr(cfg, "variant", "desmo") == "fourier"
    mod = fourier_model if is_fourier else desmo_model
    groups = mod.param_groups(mod.init_params(spec))
    periods = None
    if is_fourier and getattr(cfg, "period_multistart", 1) > 1:
        # packed period multi-start: the FFT-informed candidates become
        # per-seed period inits trained to completion simultaneously —
        # subsumes the sequential short-probe runner.fourier_period_multistart
        periods = fourier_model.period_candidates(
            np.asarray(batch["x"]),
            cfg.period_init,
            n_candidates=max(n_seeds, cfg.period_multistart),
            pod_modes=np.asarray(batch["pod_modes"]),
        )
        if log is not None:
            log(
                "[ensemble] fourier period candidates (seed s gets s mod "
                f"{len(periods)}): {np.round(periods, 4).tolist()}"
            )
        if len(periods) > n_seeds:
            # seeds cycle s % len(periods): with fewer seeds than candidates
            # the tail candidates would silently never train — say so
            if log is not None:
                log(
                    f"WARNING: {len(periods)} period candidates but only "
                    f"{n_seeds} seeds — candidates beyond the first {n_seeds} "
                    "will not be trained; raise --seeds to cover all of them"
                )
            periods = periods[:n_seeds]
        if not periods:
            # no usable candidate (non-positive period_init and a DC-flat
            # spectrum): seeds keep the spec's default period init
            periods = None

    import time as _time

    results = []  # (final_total, selection_metric, seed_index, state, local, hist)
    rec_by_seed: dict[int, float] = {}
    live_states: list[tuple[int, dict]] = []  # (global seed index, params)
    start = 0
    gi = 0
    wall = 0.0
    steps_timed = 0
    # one compiled chunk per (pack width, per-seed loss weights), shared
    # across matching groups (rebuilding per group would pay a full
    # recompile each time; a sweep's groups may slice DIFFERENT beta/lam
    # values, so the weights are part of the key)
    chunk_cache: dict = {}
    warmed: set = set()  # chunk fns that have executed at least once

    def _hyper_slice(start: int, S: int):
        """This group's per-seed (betas, lams, lr_scales) or (None,)*3."""
        if hypers is None:
            return None, None, None
        sl = slice(start, start + S)
        return hypers["betas"][sl], hypers["lams"][sl], hypers["lr_scales"][sl]

    def _get_chunk(S: int, template_params, betas=None, lams=None):
        key = (
            S,
            None if betas is None else tuple(float(v) for v in betas),
            None if lams is None else tuple(float(v) for v in lams),
        )
        if key not in chunk_cache:
            shardings = None
            if device_mesh is not None:
                from desmo_tpu import parallel

                shardings = parallel.ensemble_param_shardings(
                    template_params, device_mesh, cfg.m
                )
            loss_fn = build_loss(spec, cfg, S, betas=betas, lams=lams)
            chunk_cache[key] = make_ensemble_chunk(
                loss_fn, groups, cfg, S, param_shardings=shardings
            )
        return chunk_cache[key]

    preempted = False
    while start < n_seeds:
        if preempted or (results and train.preemption_requested()):
            # graceful preemption between seed groups: keep what's trained
            # (the first group always runs so there is a best seed to keep)
            preempted = True
            if log is not None:
                log(
                    f"graceful preemption: skipping seed groups from seed "
                    f"{start} onward ({len(results)} seeds trained)"
                )
            break
        S = min(cap, n_seeds - start)
        betas_g, lams_g, scales_g = _hyper_slice(start, S)
        group_periods = (
            [periods[(start + s) % len(periods)] for s in range(S)]
            if periods is not None
            else None
        )
        params = init_params(
            spec, S, seed=seed + gi, phi_sigma=phi_sigma,
            omega_spread=omega_spread, periods=group_periods,
        )
        if start > 0:
            # only the global seed 0 keeps the exact reference init; later
            # groups jitter every member — phi multiplicatively AND omega by
            # the same log-spread as members > 0 (else member 0 of every
            # later group duplicates global seed 0 when phi_sigma == 0)
            kphi, komega = jax.random.split(jax.random.PRNGKey(seed + 1000 + gi))
            noise = phi_sigma * jax.random.normal(
                kphi, (spec.r, spec.n), jnp.float32
            )
            params = dict(
                params,
                phi=params["phi"].at[0].multiply(1.0 + noise),
            )
            if omega_spread > 0.0:
                fac = 10.0 ** jax.random.uniform(
                    komega, params["omega"].shape[1:], jnp.float32,
                    minval=-omega_spread, maxval=omega_spread,
                )
                params["omega"] = params["omega"].at[0].multiply(fac)
        chunk = _get_chunk(S, params, betas=betas_g, lams=lams_g)
        state = jax.tree.map(
            jnp.array, init_state(params, cfg, S, lr_scales=scales_g)
        )
        chunk_size = min(cfg.checkpoint_every, num_epochs)
        done = 0
        histories = []
        frozen = np.zeros(S, bool)
        recoveries = 0
        # DEVICE-side copy of the last healthy chunk boundary: the rollback
        # target for divergence recovery. A copy, not a reference — the chunk
        # donates its input buffers.
        snap = train._snapshot_tree(state)
        while done < num_epochs:
            nsteps = min(chunk_size, num_epochs - done)
            t_chunk = _time.perf_counter()
            state, mets = chunk(state, batch, num_steps=nsteps)
            # one packed fetch of every metric (see checkpoint.device_fetch_tree)
            mets = checkpoint.device_fetch_tree(mets)
            dt = _time.perf_counter() - t_chunk
            if id(chunk) in warmed:
                wall += dt
                steps_timed += nsteps * S  # seed-steps
            else:
                warmed.add(id(chunk))  # a chunk's first call pays its compile
            tot_s = mets["total_s"]  # (nsteps, S)
            if not np.isfinite(tot_s).all():
                # one diverged seed contaminates EVERY seed's gradients within
                # a step (NaN * 0 = NaN through the packed Gram backward), so
                # attribute blame at the FIRST bad step, roll back, freeze the
                # originators, and re-run the chunk with the survivors
                finite_step = np.isfinite(tot_s).all(axis=1)
                first_bad = int(np.argmin(finite_step))
                originators = ~np.isfinite(tot_s[first_bad])
                recoveries += 1
                if not (originators & ~frozen).any():
                    originators = np.ones(S, bool)  # unattributable — global
                if (frozen | originators).all() or recoveries > max_recoveries:
                    raise FloatingPointError(
                        f"non-finite ensemble loss at epoch {done + first_bad}"
                        + (
                            " (recovery limit reached)"
                            if recoveries > max_recoveries
                            else " (every seed diverged)"
                        )
                    )
                frozen |= originators
                if log is not None:
                    log(
                        f"WARNING: seed(s) "
                        f"{(start + np.nonzero(originators)[0]).tolist()} "
                        f"diverged at epoch {done + first_bad}; rolling back "
                        f"to epoch {done} and freezing them "
                        f"({int((~frozen).sum())} live seeds continue)"
                    )
                state = _restore_with_frozen(snap, frozen)
                continue
            histories.append(mets)
            done += nsteps
            snap = train._snapshot_tree(state)
            if checkpoint_fn is not None:
                # under a hyper sweep "best live seed" means lowest REC (the
                # per-seed totals weight ortho/L1 differently)
                live_tot = np.where(
                    frozen, np.inf,
                    (mets["rec"] if hypers is not None else tot_s)[-1],
                )
                checkpoint_fn(
                    seed_state(state, cfg, int(np.argmin(live_tot))),
                    int(snap.epoch),
                )
            if log is not None and (done % max(cfg.log_every, nsteps) == 0 or done == num_epochs):
                tot = mets["total_s"][-1]
                log(
                    f"[ensemble group {gi}] epoch {done}/{num_epochs} "
                    f"per-seed total: {np.array2string(tot, precision=6)}"
                )
            if train.preemption_requested():
                # graceful preemption (same contract as train.fit): stop at
                # the chunk boundary — the per-chunk checkpoint above already
                # saved the best live seed
                preempted = True
                if log is not None:
                    log(
                        f"graceful preemption: group {gi} stopped at epoch "
                        f"{done} (of {num_epochs})"
                    )
                break
        finals = np.where(frozen, np.inf, histories[-1]["total_s"][-1])
        recs = np.where(frozen, np.inf, histories[-1]["rec"][-1])
        # the seed-selection metric: REC under a hyper sweep (totals weight
        # ortho/L1 differently and are not comparable), else the total
        sels = recs if hypers is not None else finals
        hist = {
            k: np.concatenate([h[k] for h in histories]) for k in histories[0]
        }
        for s in range(S):
            results.append(
                (float(finals[s]), float(sels[s]), start + s, state, s, hist)
            )
            rec_by_seed[start + s] = float(recs[s])
            if report is not None and not frozen[s]:
                live_states.append((start + s, extract_seed(state.params, s)))
        start += S
        gi += 1

    if preempted:
        # consume the latch (same contract as train.fit): the request is
        # honored by this fit; later fits in the process start fresh
        train.clear_preemption()
    if report is not None:
        # trained seeds are contiguous from 0 (preemption only skips later
        # groups), so this aligns with final_totals' ordering and length
        report["final_recs"] = [rec_by_seed[i] for i in sorted(rec_by_seed)]
        report["live_seeds"] = [i for i, _ in live_states]
        report["seed_params"] = [p for _, p in live_states]
    final_totals = np.asarray([r[0] for r in sorted(results, key=lambda r: r[2])])
    best_total, best_sel, best_global, best_state, best_local, best_hist = min(
        results, key=lambda r: (r[1], r[0])
    )
    if log is not None:
        by = f"rec {best_sel:.8f}, " if hypers is not None else ""
        log(
            f"[ensemble] best seed = {best_global} "
            f"({by}total {best_total:.8f}; all: "
            f"{np.array2string(final_totals, precision=6)})"
        )
        if hypers is not None:
            b, lm, sc = (
                hypers["betas"][best_global],
                hypers["lams"][best_global],
                hypers["lr_scales"][best_global],
            )
            log(
                f"[ensemble] winning hypers: beta={b:g} l1_lambda={lm:g} "
                f"lr_scale={sc:g}"
            )
    single = seed_state(best_state, cfg, best_local)
    history = {
        "rec": best_hist["rec"][:, best_local],
        "ortho": best_hist["ortho"][:, best_local],
        "l1": best_hist["l1"][:, best_local],
        "total": best_hist["total_s"][:, best_local],
    }
    sps = steps_timed / wall if wall > 0 and steps_timed else float("nan")
    result = train.TrainResult(
        state=single, history=history,
        steps_per_sec=sps,  # SEED-steps/s across all packed groups
        wall_seconds=wall,
        preempted=preempted,
    )
    return result, best_global, final_totals
