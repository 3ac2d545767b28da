"""Lane-packed multi-seed (ensemble) training: packed-vs-single parity.

The packed ensemble must be *exactly* S independent DESMO trainings: same
per-seed loss values, same gradients, same Adamax/plateau trajectories.
Trajectory comparisons use a tame omega LR — at the presets' lr_omega=1e3
the omega trajectory is chaotic and fp-noise-level association differences
(packed vs single dot tiling) amplify within ~5 steps; step-1 parity is
asserted exactly for the real-preset LRs instead."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from desmo_tpu import configs, ensemble, train
from desmo_tpu.models import desmo


def _problem(S=3, n=96, m=40, r=4, P=2, lr_omega=None):
    rng = np.random.default_rng(0)
    spec = desmo.DesmoSpec(n, m, r, P, omega_init=3.0)
    cfg = dataclasses.replace(configs.get("aneurysm"), n=n, m=m)
    if lr_omega is not None:
        cfg = dataclasses.replace(cfg, lr_omega=lr_omega)
    params = ensemble.init_params(spec, S, seed=1, phi_sigma=0.1, omega_spread=0.2)
    x = jnp.asarray(rng.standard_normal((n, m)), jnp.float32)
    pod_modes = jnp.asarray(rng.standard_normal((n, r)), jnp.float32)
    batch = {"x": x, "pod_modes": pod_modes, "x_sq": jnp.sum(x * x)}
    return spec, cfg, params, batch


def test_max_seeds_packed():
    # K=27 at r=4/P=2 -> 4 seeds; K=47 at r=4/P=3 -> 2 seeds
    assert ensemble.max_seeds_packed(desmo.DesmoSpec(10, 10, 4, 2)) == 4
    assert ensemble.max_seeds_packed(desmo.DesmoSpec(10, 10, 4, 3)) == 2
    assert ensemble.max_seeds_packed(desmo.DesmoSpec(10, 10, 2, 2)) == 10


def test_seed0_is_reference_init():
    spec = desmo.DesmoSpec(16, 8, 4, 2, omega_init=123.0)
    p = ensemble.init_params(spec, 3, phi_sigma=0.5, omega_spread=1.0)
    base = desmo.init_params(spec)
    for k in base:
        np.testing.assert_array_equal(np.asarray(p[k][0]), np.asarray(base[k]))
    # other seeds ARE jittered
    assert not np.allclose(np.asarray(p["phi"][1]), np.asarray(base["phi"]))
    assert not np.allclose(np.asarray(p["omega"][2]), np.asarray(base["omega"]))


def test_packed_loss_matches_per_seed():
    S = 3
    spec, cfg, params, batch = _problem(S)
    loss = ensemble.build_loss(spec, cfg, S)
    total, mets = loss(params, batch)
    single = desmo.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
    for s in range(S):
        t, ms = single(ensemble.extract_seed(params, s), batch)
        np.testing.assert_allclose(float(mets["rec"][s]), float(ms["rec"]), rtol=2e-5)
        np.testing.assert_allclose(float(mets["ortho"][s]), float(ms["ortho"]), rtol=2e-5)
        np.testing.assert_allclose(float(mets["l1"][s]), float(ms["l1"]), rtol=1e-6)
        np.testing.assert_allclose(float(mets["total_s"][s]), float(t), rtol=2e-5)
    np.testing.assert_allclose(float(total), float(jnp.sum(mets["total_s"])), rtol=1e-6)


def test_packed_grad_matches_per_seed():
    S = 3
    spec, cfg, params, batch = _problem(S)
    loss = ensemble.build_loss(spec, cfg, S)
    single = desmo.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
    g = jax.grad(lambda p: loss(p, batch)[0])(params)
    for s in range(S):
        gs = jax.grad(lambda p: single(p, batch)[0])(
            ensemble.extract_seed(params, s)
        )
        for k in gs:
            np.testing.assert_allclose(
                np.asarray(g[k][s]), np.asarray(gs[k]),
                rtol=5e-4, atol=1e-5, err_msg=f"seed{s}:{k}",
            )


@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("variant", ["desmo", "fourier"])
def test_factored_mse_blocks_matches_direct_per_seed(variant, S):
    """The packed block MSE equals each seed's materialized
    mean((A_s B_s - X)^2), computed in float64 NumPy."""
    from desmo_tpu.models import fourier

    n, m, r, P = 64, 24, 2, 2
    rng = np.random.default_rng(S)
    if variant == "fourier":
        spec = fourier.FourierSpec(n, m, r, P, 2.0, 3, float(m))
    else:
        spec = desmo.DesmoSpec(n, m, r, P, omega_init=2.0)
    params = ensemble.init_params(spec, S, seed=2, phi_sigma=0.2, omega_spread=0.3)
    pod_modes = jnp.asarray(rng.standard_normal((n, r)) / np.sqrt(n), jnp.float32)
    x = jnp.asarray(rng.standard_normal((n, m)), jnp.float32)
    A, _ = ensemble.packed_dictionary(
        params, pod_modes, spec, ensemble.packed_factor_table(spec, S)
    )
    if variant == "fourier":
        B = ensemble.packed_temporal_fourier(params, jnp.asarray(fourier.t_points(m)))
    else:
        B = ensemble.packed_temporal(params)
    got = np.asarray(ensemble.factored_mse_blocks(A, B, x, None, S))
    K = A.shape[1] // S
    a64, b64, x64 = (np.asarray(v, np.float64) for v in (A, B, x))
    want = [
        np.mean((a64[:, s * K:(s + 1) * K] @ b64[s * K:(s + 1) * K] - x64) ** 2)
        for s in range(S)
    ]
    assert got.shape == (S,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_one_step_exact_at_preset_lrs():
    """At the real preset LRs (incl. lr_omega=1e3) the FIRST step must match
    the single-seed trainer bitwise-closely (before chaos can amplify)."""
    S = 3
    spec, cfg, params, batch = _problem(S)
    loss = ensemble.build_loss(spec, cfg, S)
    groups = desmo.param_groups(desmo.init_params(spec))
    chunk = ensemble.make_ensemble_chunk(loss, groups, cfg, S)
    st = jax.tree.map(jnp.array, ensemble.init_state(params, cfg, S))
    st, mets = chunk(st, batch, num_steps=1)
    single = desmo.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
    sc = train.make_train_chunk(single, groups, cfg)
    for s in range(S):
        ss = jax.tree.map(
            jnp.array, train.init_state(ensemble.extract_seed(params, s), cfg)
        )
        ss, sm = sc(ss, batch, num_steps=1)
        np.testing.assert_allclose(
            float(mets["total_s"][-1][s]), float(sm["total"][-1]), rtol=1e-6
        )
        for k in ss.params:
            np.testing.assert_allclose(
                np.asarray(st.params[k][s]), np.asarray(ss.params[k]),
                rtol=1e-5, atol=1e-7, err_msg=f"seed{s}:{k}",
            )


@pytest.mark.slow
def test_trajectory_parity_tame_lrs():
    """60 packed steps == 60 single-seed steps for every seed (tame omega LR;
    scheduler rows must evolve independently and match too)."""
    S = 3
    spec, cfg, params, batch = _problem(S, lr_omega=0.1)
    loss = ensemble.build_loss(spec, cfg, S)
    groups = desmo.param_groups(desmo.init_params(spec))
    chunk = ensemble.make_ensemble_chunk(loss, groups, cfg, S)
    st = jax.tree.map(jnp.array, ensemble.init_state(params, cfg, S))
    st, mets = chunk(st, batch, num_steps=60)
    single = desmo.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
    sc = train.make_train_chunk(single, groups, cfg)
    for s in range(S):
        ss = jax.tree.map(
            jnp.array, train.init_state(ensemble.extract_seed(params, s), cfg)
        )
        ss, sm = sc(ss, batch, num_steps=60)
        np.testing.assert_allclose(
            float(mets["total_s"][-1][s]), float(sm["total"][-1]), rtol=1e-4
        )
        for k in ss.params:
            np.testing.assert_allclose(
                np.asarray(st.params[k][s]), np.asarray(ss.params[k]),
                rtol=1e-4, atol=1e-6, err_msg=f"seed{s}:{k}",
            )
        np.testing.assert_allclose(
            np.asarray(st.sched.lrs[s]), np.asarray(ss.sched.lrs), rtol=1e-6
        )


def test_seed_state_resumes_on_single_chunk():
    """extract-best-then-continue: the single-seed TrainState view must be
    directly consumable by the standard scanned chunk."""
    S = 2
    spec, cfg, params, batch = _problem(S, lr_omega=0.1)
    loss = ensemble.build_loss(spec, cfg, S)
    groups = desmo.param_groups(desmo.init_params(spec))
    chunk = ensemble.make_ensemble_chunk(loss, groups, cfg, S)
    st = jax.tree.map(jnp.array, ensemble.init_state(params, cfg, S))
    st, _ = chunk(st, batch, num_steps=10)
    sview = jax.tree.map(jnp.array, ensemble.seed_state(st, cfg, 1))
    single = desmo.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
    sc = train.make_train_chunk(single, groups, cfg)
    s2, mets = sc(sview, batch, num_steps=5)
    assert np.isfinite(np.asarray(mets["total"])).all()
    assert int(s2.epoch) == 15


def test_fit_selects_best_seed():
    """End-to-end ensemble.fit: more seeds than fit in one pack (forces two
    packed groups), best-by-final-total selection, resumable best state."""
    S = 6  # cap is 4 at K=27 -> groups of 4 + 2
    spec, cfg, params, batch = _problem(3, lr_omega=0.1)
    cfg = dataclasses.replace(cfg, checkpoint_every=50, log_every=1000)
    result, best, finals = ensemble.fit(
        cfg, spec, batch, n_seeds=S, num_epochs=40, seed=0,
        phi_sigma=0.1, omega_spread=0.2, log=None,
    )
    assert finals.shape == (S,)
    assert np.isfinite(finals).all()
    assert best == int(np.argmin(finals))
    assert result.history["total"].shape == (40,)
    # the returned state is the best member's and is standard single-seed
    assert result.state.params["phi"].shape == (spec.r, spec.n)
    np.testing.assert_allclose(
        float(result.history["total"][-1]), float(finals[best]), rtol=1e-6
    )


def test_fit_recovers_from_diverged_seed():
    """A diverged seed must NOT kill the ensemble: it is rolled back, frozen
    (final total inf, excluded from best), and the survivors finish. Here the
    jitter is so large the jittered seeds' poly terms overflow at init while
    seed 0 (exact reference init) stays healthy."""
    spec, cfg, params, batch = _problem(3, lr_omega=0.1)
    cfg = dataclasses.replace(cfg, checkpoint_every=10, log_every=1000)
    msgs = []
    result, best, finals = ensemble.fit(
        cfg, spec, batch, n_seeds=3, num_epochs=20, seed=0,
        phi_sigma=1e200, omega_spread=0.0, log=msgs.append,
    )
    assert best == 0
    assert np.isfinite(finals[0])
    assert np.isinf(finals[1]) and np.isinf(finals[2])
    assert any("diverged" in m for m in msgs)
    # the survivor's returned state is finite and standard single-seed
    for v in jax.tree.leaves(result.state.params):
        assert np.isfinite(np.asarray(v)).all()
    assert result.history["total"].shape == (20,)
    assert np.isfinite(result.history["total"]).all()


def test_fit_raises_when_all_seeds_diverge():
    """When every seed is non-finite at the same step there is nothing to
    rescue — fit must still fail loudly (single-seed abort semantics)."""
    spec, cfg, params, batch = _problem(3, lr_omega=0.1)
    cfg = dataclasses.replace(cfg, checkpoint_every=10, log_every=1000)
    batch = dict(batch, x=jnp.full_like(batch["x"], jnp.inf), x_sq=jnp.inf)
    with pytest.raises(FloatingPointError):
        ensemble.fit(
            cfg, spec, batch, n_seeds=2, num_epochs=20, seed=0,
            phi_sigma=0.1, log=None,
        )


def test_fit_checkpoint_fn_called_each_chunk():
    """checkpoint_fn fires at every chunk boundary with a single-seed state
    (crash mid-run loses at most checkpoint_every epochs, like train.fit)."""
    spec, cfg, params, batch = _problem(3, lr_omega=0.1)
    cfg = dataclasses.replace(cfg, checkpoint_every=10, log_every=1000)
    saved = []
    ensemble.fit(
        cfg, spec, batch, n_seeds=2, num_epochs=40, seed=0,
        phi_sigma=0.1, log=None,
        checkpoint_fn=lambda st, ep: saved.append((ep, st)),
    )
    assert [ep for ep, _ in saved] == [10, 20, 30, 40]
    for _, st in saved:
        assert st.params["phi"].shape == (spec.r, spec.n)


def test_fit_caches_chunk_across_groups(monkeypatch):
    """Same-width packed groups share one compiled chunk (no per-group
    recompile): 8 seeds at cap 4 -> two groups -> ONE chunk build."""
    spec, cfg, params, batch = _problem(3, lr_omega=0.1)
    cfg = dataclasses.replace(cfg, checkpoint_every=20, log_every=1000)
    builds = []
    orig = ensemble.make_ensemble_chunk

    def counting(*a, **k):
        builds.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(ensemble, "make_ensemble_chunk", counting)
    result, best, finals = ensemble.fit(
        cfg, spec, batch, n_seeds=8, num_epochs=20, seed=0,
        phi_sigma=0.1, log=None,
    )
    assert len(builds) == 1
    assert finals.shape == (8,)
    assert np.isfinite(finals).all()


def test_mesh_ensemble_matches_single_device():
    """Multi-start composes with the device mesh: the sharding-aware packed
    scan chunk (seeds in lanes, phi rows over 'space') must reproduce the
    unsharded packed chunk step-for-step, with phi and its moments actually
    left distributed on the output state."""
    from desmo_tpu import parallel
    from desmo_tpu.parallel import make_mesh

    S = 3
    spec, cfg, params, batch = _problem(S, lr_omega=0.1)
    loss = ensemble.build_loss(spec, cfg, S)
    groups = desmo.param_groups(desmo.init_params(spec))
    mesh = make_mesh(n_space=4, n_time=2)
    shardings = parallel.ensemble_param_shardings(params, mesh, cfg.m)
    chunk_sh = ensemble.make_ensemble_chunk(
        loss, groups, cfg, S, param_shardings=shardings
    )
    with jax.sharding.set_mesh(mesh):
        batch_sh = parallel.shard_batch(batch, mesh)
        st_sh = jax.tree.map(jnp.array, ensemble.init_state(params, cfg, S))
        st_sh, m_sh = chunk_sh(st_sh, batch_sh, num_steps=20)

    chunk = ensemble.make_ensemble_chunk(loss, groups, cfg, S)
    st = jax.tree.map(jnp.array, ensemble.init_state(params, cfg, S))
    st, m = chunk(st, batch, num_steps=20)

    np.testing.assert_allclose(
        np.asarray(m_sh["total_s"]), np.asarray(m["total_s"]),
        rtol=5e-4, atol=1e-6,
    )
    for k in st.params:
        np.testing.assert_allclose(
            np.asarray(st_sh.params[k]), np.asarray(st.params[k]),
            rtol=5e-4, atol=1e-5, err_msg=k,
        )
    # phi (and its Adamax moments) must come out sharded over 'space'
    for tree in (st_sh.params, st_sh.opt.mu, st_sh.opt.nu):
        shard = next(iter(tree["phi"].addressable_shards))
        assert shard.data.shape == (S, spec.r, spec.n // 4), tree["phi"].sharding
        assert "space" in str(tree["phi"].sharding.spec)


def test_fit_recovers_mid_run_divergence(monkeypatch):
    """Divergence in a LATER chunk: fit must roll back to the previous
    (trained) chunk boundary, freeze the originator, re-run the chunk, and
    keep epoch accounting/history exact. Injected by wrapping the compiled
    chunk: call #2 reports seed 1 non-finite."""
    spec, cfg, params, batch = _problem(3, lr_omega=0.1)
    cfg = dataclasses.replace(cfg, checkpoint_every=10, log_every=1000)
    real_make = ensemble.make_ensemble_chunk
    calls = {"n": 0}

    def wrapped_make(*a, **k):
        chunk = real_make(*a, **k)

        def injected(state, batch, num_steps):
            out_state, mets = chunk(state, batch, num_steps=num_steps)
            calls["n"] += 1
            if calls["n"] == 2:  # second chunk: seed 1 "diverges" mid-chunk
                bad = np.asarray(mets["total_s"]).copy()
                bad[num_steps // 2 :, 1] = np.inf
                mets = dict(mets, total_s=jnp.asarray(bad))
            return out_state, mets

        return injected

    monkeypatch.setattr(ensemble, "make_ensemble_chunk", wrapped_make)
    msgs = []
    result, best, finals = ensemble.fit(
        cfg, spec, batch, n_seeds=3, num_epochs=40, seed=0,
        phi_sigma=0.1, log=msgs.append,
    )
    assert any("diverged at epoch 15" in m for m in msgs), msgs
    assert np.isinf(finals[1]) and np.isfinite(finals[0]) and np.isfinite(finals[2])
    assert best in (0, 2)
    assert int(result.state.epoch) == 40
    assert result.history["total"].shape == (40,)
    assert np.isfinite(result.history["total"]).all()


def test_fit_mesh_multi_chunk():
    """ensemble.fit under a device mesh runs the sharding-aware packed chunk
    end to end over several chunks (best-seed selection, single-seed result
    state)."""
    import dataclasses as dc

    from desmo_tpu.parallel import make_mesh

    spec, cfg, params, batch = _problem(2, lr_omega=0.1)
    cfg = dc.replace(cfg, checkpoint_every=6, log_every=1000)
    mesh = make_mesh(n_space=4, n_time=2)
    result, best, finals = ensemble.fit(
        cfg, spec, batch, n_seeds=2, num_epochs=12, seed=0,
        phi_sigma=0.1, log=None, device_mesh=mesh,
    )
    assert finals.shape == (2,)
    assert np.isfinite(finals).all()
    assert int(result.state.epoch) == 12
    assert result.state.params["phi"].shape == (spec.r, spec.n)
    assert np.isfinite(result.history["total"]).all()


def test_fit_honors_graceful_preemption():
    """ensemble.fit stops at the chunk boundary when preemption is requested
    (same contract as train.fit — the CLI installs the SIGTERM handler for
    --seeds runs too): one chunk runs, later chunks and groups are skipped,
    the per-chunk checkpoint already saved the best live seed, and the
    result carries preempted=True."""
    from desmo_tpu import train

    spec, cfg, params, batch = _problem(3)
    cfg = dataclasses.replace(cfg, checkpoint_every=10, num_epochs=40)
    saved = []
    train.request_preemption()
    try:
        result, best, finals = ensemble.fit(
            cfg, spec, batch, n_seeds=3, num_epochs=40, log=None,
            checkpoint_fn=lambda st, ep: saved.append(ep),
        )
    finally:
        train.clear_preemption()
    assert result.preempted
    assert int(result.state.epoch) == 10  # one chunk, then the boundary stop
    assert saved == [10]
    assert len(finals) == 3 and np.isfinite(finals).all()


# --- hyperparameter multi-start (per-seed beta / l1_lambda / lr_scale) -------


def test_resolve_hypers_grid():
    """Cartesian combo grid, seed cycling, and the no-sweep None contract."""
    cfg = configs.get("aneurysm")
    assert ensemble.resolve_hypers(cfg, 4) is None
    cfg2 = dataclasses.replace(
        cfg, sweep_beta=(1e-3, 1e-4), sweep_lam=(1e-4, 1e-5)
    )
    h = ensemble.resolve_hypers(cfg2, 4)
    assert len(h["combos"]) == 4
    np.testing.assert_allclose(h["betas"], [1e-3, 1e-3, 1e-4, 1e-4], rtol=1e-6)
    np.testing.assert_allclose(h["lams"], [1e-4, 1e-5, 1e-4, 1e-5], rtol=1e-6)
    np.testing.assert_allclose(h["lr_scales"], np.ones(4))
    # more seeds than combos: combos cycle (k inits per combo)
    h6 = ensemble.resolve_hypers(cfg2, 6)
    np.testing.assert_allclose(h6["betas"], [1e-3, 1e-3, 1e-4, 1e-4, 1e-3, 1e-3], rtol=1e-6)
    # fewer seeds than combos: warn that the grid tail is untrained
    with pytest.warns(UserWarning, match="combos"):
        ensemble.resolve_hypers(cfg2, 2)
    # a single-axis sweep keeps the cfg values on the other axes
    h1 = ensemble.resolve_hypers(
        dataclasses.replace(cfg, sweep_lr_scale=(1.0, 0.5)), 2
    )
    np.testing.assert_allclose(h1["betas"], [cfg.beta] * 2, rtol=1e-6)
    np.testing.assert_allclose(h1["lr_scales"], [1.0, 0.5])


def test_hyper_loss_matches_per_seed_cfg():
    """Per-seed beta/lam in the packed loss == each seed under its own cfg."""
    S = 3
    spec, cfg, params, batch = _problem(S)
    betas = np.array([1e-3, 5e-3, 1e-2], np.float32)
    lams = np.array([1e-4, 1e-5, 1e-3], np.float32)
    loss = ensemble.build_loss(
        spec, cfg, S, betas=betas, lams=lams
    )
    _, mets = loss(params, batch)
    for s in range(S):
        single = desmo.build_loss(
            spec, float(betas[s]), float(lams[s]), method="factored"
        )
        t, _ = single(ensemble.extract_seed(params, s), batch)
        np.testing.assert_allclose(
            float(mets["total_s"][s]), float(t), rtol=2e-5, err_msg=f"seed{s}"
        )


def test_hyper_trajectory_matches_single_runs():
    """The hyperparameter multi-start IS S independent runs: each packed
    seed's 40-step trajectory under its own (beta, lambda, lr_scale) matches
    a single-seed training whose cfg carries exactly those values (lr scales
    chosen as powers of two so both float routes are bit-equal)."""
    S = 3
    spec, cfg, params, batch = _problem(S, lr_omega=0.1)
    betas = np.array([1e-3, 5e-3, 1e-2], np.float32)
    lams = np.array([1e-4, 1e-5, 1e-3], np.float32)
    scales = np.array([1.0, 0.5, 2.0], np.float32)
    loss = ensemble.build_loss(
        spec, cfg, S, betas=betas, lams=lams
    )
    groups = desmo.param_groups(desmo.init_params(spec))
    chunk = ensemble.make_ensemble_chunk(loss, groups, cfg, S)
    st = jax.tree.map(
        jnp.array, ensemble.init_state(params, cfg, S, lr_scales=scales)
    )
    st, mets = chunk(st, batch, num_steps=40)
    for s in range(S):
        sc = float(scales[s])
        cfg_s = dataclasses.replace(
            cfg, beta=float(betas[s]), l1_lambda=float(lams[s]),
            lr_coef=cfg.lr_coef * sc, lr_phi=cfg.lr_phi * sc,
            lr_z=cfg.lr_z * sc, lr_omega=cfg.lr_omega * sc,
            lr_period=cfg.lr_period * sc,
        )
        single = desmo.build_loss(
            spec, cfg_s.beta, cfg_s.l1_lambda, method="factored"
        )
        schunk = train.make_train_chunk(single, groups, cfg_s)
        ss = jax.tree.map(
            jnp.array,
            train.init_state(ensemble.extract_seed(params, s), cfg_s),
        )
        ss, sm = schunk(ss, batch, num_steps=40)
        np.testing.assert_allclose(
            float(mets["total_s"][-1][s]), float(sm["total"][-1]), rtol=1e-4
        )
        for k in ss.params:
            np.testing.assert_allclose(
                np.asarray(st.params[k][s]), np.asarray(ss.params[k]),
                rtol=1e-4, atol=1e-6, err_msg=f"seed{s}:{k}",
            )
        np.testing.assert_allclose(
            np.asarray(st.sched.lrs[s]), np.asarray(ss.sched.lrs), rtol=1e-6
        )


def test_fit_hyper_sweep_selects_by_rec():
    """Under a sweep, per-seed totals weight ortho/L1 differently, so fit
    must pick the winner by REC: seed 0 (lr_scale 0, lam 0) never trains and
    keeps the lower TOTAL, seed 1 (huge lam) trains to the lower REC — the
    rec-trained seed must win despite its penalty-inflated total."""
    spec, cfg, params, batch = _problem(2, lr_omega=0.1)
    cfg = dataclasses.replace(cfg, checkpoint_every=20, log_every=1000)
    hypers = {
        "betas": np.array([1e-3, 1e-3], np.float32),
        "lams": np.array([0.0, 5.0], np.float32),
        "lr_scales": np.array([0.0, 1.0], np.float32),
        "combos": [(1e-3, 0.0, 0.0), (1e-3, 5.0, 1.0)],
    }
    logs = []
    result, best, finals = ensemble.fit(
        cfg, spec, batch, n_seeds=2, num_epochs=40, seed=0, phi_sigma=0.0,
        log=logs.append, hypers=hypers,
    )
    # seed 1's total carries ~5 * sum|c| of penalty -> far above seed 0's
    assert finals[1] > finals[0]
    # ...but it trained (seed 0 could not: lr_scale 0) -> best REC wins
    assert best == 1
    assert any("winning hypers" in line for line in logs)
    assert any("l1_lambda=5" in line for line in logs)


def test_fit_resolves_cfg_sweep_and_spans_groups():
    """fit() picks up cfg.sweep_* automatically and a sweep slices correctly
    across multiple packed groups (cap 4 at K=27 -> groups of 4 + 2)."""
    spec, cfg, params, batch = _problem(3, lr_omega=0.1)
    cfg = dataclasses.replace(
        cfg, checkpoint_every=20, log_every=1000,
        sweep_beta=(1e-3, 1e-2), sweep_lam=(1e-4, 1e-5), n_seeds=6,
    )
    logs = []
    result, best, finals = ensemble.fit(
        cfg, spec, batch, n_seeds=6, num_epochs=20, seed=0, phi_sigma=0.05,
        log=logs.append,
    )
    assert finals.shape == (6,)
    assert np.isfinite(finals).all()
    assert any("hyperparameter multi-start: 4" in line for line in logs)
    assert result.state.params["phi"].shape == (spec.r, spec.n)


def test_term_stability_report():
    """Cross-seed term-stability: a term active in every member has
    frequency 1.0; a term zeroed in one member is flagged fractional; the
    name row order is [poly terms, interleaved trig] (reference order)."""
    spec = desmo.DesmoSpec(24, 12, 2, 2, omega_init=1.0)
    params = ensemble.init_params(spec, 2, seed=0, phi_sigma=0.1)
    a = ensemble.extract_seed(params, 0)
    b = ensemble.extract_seed(params, 1)
    # term 1 ('phi1') inactive in member b only; term 0 ('1') in both
    b = dict(b, c=b["c"].at[1].set(0.0))
    stab = ensemble.term_stability([a, b], spec, threshold=1e-12)
    from desmo_tpu import library

    T = spec.num_poly_terms
    assert stab["names"][:2] == ["1", "phi1"]
    assert stab["names"][T:T + 3] == ["sin(phi1)", "cos(phi1)", "tanh(phi1)"]
    assert stab["energies"].shape == (2, T + 3 * spec.r)
    assert stab["frequency"][0] == 1.0
    assert stab["frequency"][1] == 0.5
    np.testing.assert_allclose(
        stab["mean"], stab["energies"].mean(axis=0), rtol=1e-6
    )


def test_fit_report_carries_live_seed_states():
    """fit(report=...) exposes every non-diverged member's params (the
    term_stability input — params only, so the report doesn't pin every
    member's Adamax moments); diverged seeds are excluded."""
    spec, cfg, params, batch = _problem(3, lr_omega=0.1)
    cfg = dataclasses.replace(cfg, checkpoint_every=10, log_every=1000)
    report = {}
    result, best, finals = ensemble.fit(
        cfg, spec, batch, n_seeds=3, num_epochs=20, seed=0,
        phi_sigma=1e200,  # jittered seeds 1,2 diverge; seed 0 survives
        log=None, report=report,
    )
    assert report["live_seeds"] == [0]
    assert len(report["seed_params"]) == 1
    p0 = report["seed_params"][0]
    assert p0["phi"].shape == (spec.r, spec.n)
    stab = ensemble.term_stability([p0], spec)
    assert stab["energies"].shape[0] == 1
