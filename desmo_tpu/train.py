"""On-device training loop for all DESMO variants.

The reference trains full-batch — ``batchsize = m`` makes the DataLoader loop
vestigial, so 1 optimizer step == 1 epoch (``DESMO/cylinder_flow/
DESMO-Cylinder.py:358,706-786``) — at ~28 steps/s on a GPU, bounded by Python
overhead, per-step host->device copies and ~40 small kernel launches per step
(SURVEY §3.1). This redesign compiles the *whole* loop:

* one jitted ``train_chunk`` runs K epochs inside ``lax.scan`` — no host
  round-trips, no per-step dispatch;
* the ReduceLROnPlateau scheduler and the per-group Adamax LRs are pure carried
  state (`desmo_tpu.optim`), including the reference's quirk of stepping the
  scheduler only every ``sched_every`` epochs (``CYL:776-778``);
* per-epoch metrics (rec/ortho/L1/total) are accumulated on device and
  returned as arrays, so logging matches the reference's `.out` format without
  touching throughput.

The loss function is supplied by the model variant; the trainer is generic.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from desmo_tpu import optim
from desmo_tpu.configs import GROUP_ORDER, RunConfig

LossFn = Callable[[dict, dict], tuple[jnp.ndarray, dict]]
"""(params, batch) -> (total_loss, metrics dict incl. 'rec','ortho','l1')."""


@jax.jit
def _snapshot_tree(tree):
    """Device-side copy of a pytree in one dispatch (instead of one eager
    copy per leaf). Used to decouple checkpoint fetches from the donated
    training-state buffers."""
    return jax.tree.map(jnp.copy, tree)


# --- graceful preemption (SURVEY §5.3 failure detection/recovery) ---------
# SLURM preemption / spot-VM reclaim sends SIGTERM with a short grace window;
# the reference's scripts die mid-step and lose up to checkpoint_every epochs.
# Here a preemption request stops fit() at the NEXT CHUNK BOUNDARY, forces a
# final (off-cadence) checkpoint through checkpoint_fn, and returns cleanly
# with result.preempted=True — resume via checkpoint.load_state is bit-exact.
_PREEMPT = None


def _preempt_event():
    global _PREEMPT
    if _PREEMPT is None:
        import threading

        _PREEMPT = threading.Event()
    return _PREEMPT


def request_preemption() -> None:
    """Ask any running :func:`fit` to stop at its next chunk boundary (after
    a final checkpoint). Safe from signal handlers and other threads. The
    request is CONSUMED by the fit that honors it (one request = one stop);
    a fresh SIGTERM re-arms it."""
    _preempt_event().set()


def preemption_requested() -> bool:
    return _preempt_event().is_set()


def clear_preemption() -> None:
    _preempt_event().clear()


def install_preemption_handler(signals=None) -> None:
    """Arm SIGTERM-graceful training for this process: the signals (default
    ``(SIGTERM,)`` — what SLURM preemption and spot-VM reclaim deliver)
    request a chunk-boundary stop instead of killing the run mid-chunk.
    Chains any previously-installed handler. Main thread only (CPython's
    signal rule); library users opt in — only the CLI installs it by
    default."""
    import signal as _signal

    if signals is None:
        signals = (_signal.SIGTERM,)
    for sig in signals:
        prev = _signal.getsignal(sig)

        def _handler(signum, frame, _prev=prev):
            request_preemption()
            if callable(_prev):
                _prev(signum, frame)

        _signal.signal(sig, _handler)


_CKPT_POOL = None


def _ckpt_pool():
    global _CKPT_POOL
    if _CKPT_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _CKPT_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
    return _CKPT_POOL


class TrainState(NamedTuple):
    params: dict
    opt: optim.AdamaxState
    sched: optim.PlateauState
    epoch: jnp.ndarray  # int32, number of epochs already taken


def init_state(params: dict, cfg: RunConfig) -> TrainState:
    return TrainState(
        params=params,
        opt=optim.adamax_init(params),
        sched=optim.plateau_init(jnp.asarray(cfg.group_lrs, jnp.float32)),
        epoch=jnp.zeros((), jnp.int32),
    )


class _FlatLayout:
    """Static description of the packed parameter buffer.

    Inside the compiled training chunk all parameters live in ONE contiguous
    fp32 vector: the Adamax update then runs as three fused element-wise ops
    over the whole buffer (with per-element LRs gathered from the group-LR
    vector) instead of a per-leaf op soup. The pytree view is reconstructed
    by cheap slices that XLA fuses into the loss computation.
    """

    def __init__(self, params: dict, group_of: dict[str, str]):
        self.keys = list(params)
        self.shapes = {k: tuple(np.shape(params[k])) for k in self.keys}
        sizes = {k: int(np.prod(self.shapes[k])) for k in self.keys}
        self.offsets = {}
        off = 0
        for k in self.keys:
            self.offsets[k] = off
            off += sizes[k]
        self.total = off
        gidx = np.empty(off, np.int32)
        for k in self.keys:
            gidx[self.offsets[k] : self.offsets[k] + sizes[k]] = GROUP_ORDER.index(
                group_of[k]
            )
        self.group_index = gidx

    def flatten(self, tree: dict) -> jnp.ndarray:
        if not self.keys:  # every leaf sharded: nothing packed
            return jnp.zeros((0,), jnp.float32)
        return jnp.concatenate(
            [jnp.ravel(tree[k]).astype(jnp.float32) for k in self.keys]
        )

    def unflatten(self, vec: jnp.ndarray) -> dict:
        out = {}
        for k in self.keys:
            size = int(np.prod(self.shapes[k]))
            out[k] = jax.lax.dynamic_slice_in_dim(vec, self.offsets[k], size).reshape(
                self.shapes[k]
            )
        return out


def _sched_update(sched, total, epoch, cfg: RunConfig):
    """Plateau step applied on the reference's cadence (CYL:776-778): stepped
    with this epoch's pre-update total loss, only when epoch % sched_every == 0."""
    stepped = optim.plateau_step(
        sched,
        total,
        patience=cfg.patience,
        factor=cfg.sched_factor,
        min_lr=cfg.sched_min_lr,
    )
    do_sched = epoch % cfg.sched_every == 0
    return jax.tree.map(lambda a, b: jnp.where(do_sched, a, b), stepped, sched)


def make_epoch_step(loss_fn: LossFn, group_of: dict[str, str], cfg: RunConfig):
    """Build the pure one-epoch step: (state, batch) -> (state, metrics).

    Reference implementation over pytrees — readable, used in tests; the
    compiled loop in `make_train_chunk` uses the packed-buffer equivalent.
    """

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        (total, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch
        )
        lr_tree = optim.lr_tree_from_groups(
            state.params, group_of, GROUP_ORDER, state.sched.lrs
        )
        updates, opt = optim.adamax_update(grads, state.opt, lr_tree)
        params = jax.tree.map(lambda p, u: p + u, state.params, updates)
        sched = _sched_update(state.sched, total, state.epoch, cfg)
        metrics = dict(metrics)
        metrics["total"] = total
        return TrainState(params, opt, sched, state.epoch + 1), metrics

    return step


def _is_sharded(sharding) -> bool:
    """True when a NamedSharding actually splits data over mesh axes."""
    spec = getattr(sharding, "spec", None)
    return spec is not None and any(ax is not None for ax in spec)


def make_train_chunk(
    loss_fn: LossFn,
    group_of: dict[str, str],
    cfg: RunConfig,
    param_shardings: Optional[dict] = None,
    unroll: Optional[int] = None,
):
    """Jitted scan of `num_steps` epochs. Returns (state, stacked metrics).

    Semantically identical to scanning `make_epoch_step` (tested), but packs
    params and Adamax moments into single flat buffers for the duration of the
    chunk so the update is three fused vector ops.

    ``param_shardings`` (key -> ``NamedSharding``, from
    ``parallel.param_shardings``) makes the compiled loop **sharding-aware**:
    leaves whose spec splits a mesh axis (phi over 'space', z/z_trig over
    'time') are carried per-leaf through the scan, pinned each iteration with
    ``lax.with_sharding_constraint`` so their parameters AND Adamax moments
    stay distributed — per-device memory for the O(r*n) state scales as 1/
    n_space. Packing them into the flat buffer would let XLA resolve the
    concatenated vector (and both moments) to fully-replicated, defeating
    spatial sharding. Replicated leaves keep the packed fast path, so the
    single-chip step is unchanged when no sharding is requested.
    """
    if unroll is None:
        unroll = getattr(cfg, "scan_unroll", 1)
    sharded_sh = {
        k: s for k, s in (param_shardings or {}).items() if _is_sharded(s)
    }

    def chunk_impl(state: TrainState, batch: dict, num_steps: int):
        packed_keys = [k for k in state.params if k not in sharded_sh]
        layout = _FlatLayout({k: state.params[k] for k in packed_keys}, group_of)
        gidx = jnp.asarray(layout.group_index)
        # one static scalar LR index per sharded leaf (each leaf has one group)
        sh_lr_idx = {k: GROUP_ORDER.index(group_of[k]) for k in sharded_sh}

        def pin(tree: dict) -> dict:
            return {
                k: jax.lax.with_sharding_constraint(v, sharded_sh[k])
                for k, v in tree.items()
            }

        def full_loss(vec, sh_params, batch):
            params = layout.unflatten(vec)
            params.update(sh_params)
            return loss_fn(params, batch)

        b1, b2, eps = 0.9, 0.999, 1e-8

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
            lr_elem = sched.lrs[gidx]  # per-element LR via one gather
            vec = vec - (lr_elem / bias) * mu / nu
            sh_mu = pin(
                {k: b1 * sh_mu[k] + (1.0 - b1) * g_sh[k] for k in sh_mu}
            )
            sh_nu = pin(
                {
                    k: jnp.maximum(b2 * sh_nu[k], jnp.abs(g_sh[k]) + eps)
                    for k in sh_nu
                }
            )
            sh_p = pin(
                {
                    k: sh_p[k]
                    - (sched.lrs[sh_lr_idx[k]] / bias) * sh_mu[k] / sh_nu[k]
                    for k in sh_p
                }
            )
            sched = _sched_update(sched, total, epoch, cfg)
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
            unroll=min(unroll, num_steps),
        )

        def rebuild(vec, sh_tree):
            out = layout.unflatten(vec)
            out.update(sh_tree)
            return {k: out[k] for k in state.params}  # original key order

        out_state = TrainState(
            params=rebuild(vec, sh_p),
            opt=optim.AdamaxState(count, rebuild(mu, sh_mu), rebuild(nu, sh_nu)),
            sched=sched,
            epoch=epoch,
        )
        return out_state, metrics

    return jax.jit(chunk_impl, static_argnames=("num_steps",), donate_argnames=("state",))


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: dict[str, np.ndarray]  # per-epoch metrics
    steps_per_sec: float
    wall_seconds: float
    # True when the run stopped early at a chunk boundary because preemption
    # was requested (request_preemption / install_preemption_handler); the
    # final state was checkpointed and is bit-exact resumable
    preempted: bool = False


def fit(
    loss_fn: LossFn,
    group_of: dict[str, str],
    cfg: RunConfig,
    params: dict,
    batch: dict,
    num_epochs: Optional[int] = None,
    chunk_size: Optional[int] = None,
    log: Optional[Callable[[str], None]] = print,
    checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
    state: Optional[TrainState] = None,
    param_shardings: Optional[dict] = None,
) -> TrainResult:
    """Run (or resume) training; host code only between compiled chunks.

    ``checkpoint_fn(state, epoch)`` is invoked every ``cfg.checkpoint_every``
    epochs, mirroring the reference's periodic ``torch.save`` (``CYL:781-786``)
    — but from chunk boundaries, never from inside the compiled loop.

    Threading contract: ``checkpoint_fn`` runs ASYNCHRONOUSLY on a worker
    thread against an on-device snapshot of the state, overlapping the next
    chunk's compute. It must therefore be thread-safe, and may dispatch jitted
    JAX fetches concurrently with the training loop (safe for the fetch
    helpers in ``checkpoint``; custom fns must not mutate shared host state
    without locking). A failed save raises at the next chunk boundary (the
    loop polls the pending future each chunk), at the next checkpoint submit,
    or at the end of ``fit`` — never silently.

    Graceful preemption: when :func:`request_preemption` fires (directly, or
    via the SIGTERM handler from :func:`install_preemption_handler`), the
    loop finishes the in-flight compiled chunk, forces an off-cadence
    ``checkpoint_fn`` save, and returns early with ``result.preempted=True``;
    resuming from that state is bit-exact (``tests/test_train.py``).
    """
    num_epochs = cfg.num_epochs if num_epochs is None else num_epochs
    if num_epochs <= 0:
        state = init_state(params, cfg) if state is None else state
        return TrainResult(state=state, history={}, steps_per_sec=float("nan"), wall_seconds=0.0)
    chunk_size = chunk_size or min(cfg.checkpoint_every, num_epochs)
    train_chunk = make_train_chunk(loss_fn, group_of, cfg, param_shardings)
    if state is None:
        state = init_state(params, cfg)
    # train_chunk donates its state buffers; copy so the caller's params /
    # resume state stay alive after fit() returns.
    state = jax.tree.map(jnp.array, state)
    batch = jax.tree.map(jnp.asarray, batch)

    if preemption_requested():
        # the latch was raised before this fit started (e.g. SIGTERM during
        # an earlier warmup/probe phase that re-raised it): stop before the
        # first chunk, but still save a resumable checkpoint of the incoming
        # state — it may carry unsaved work from that earlier phase
        if checkpoint_fn is not None:
            checkpoint_fn(_snapshot_tree(state), int(state.epoch))
        if log is not None:
            saved = (
                "incoming state checkpointed" if checkpoint_fn is not None
                else "no checkpoint_fn — state NOT saved"
            )
            log(f"graceful preemption: stopped before the first chunk; {saved}")
        clear_preemption()
        return TrainResult(
            state=state, history={}, steps_per_sec=float("nan"),
            wall_seconds=0.0, preempted=True,
        )

    histories: list[dict] = []
    _ckpt_pending = None
    start_epoch = int(state.epoch)
    end_epoch = start_epoch + num_epochs
    t0 = None  # started after the first chunk, to exclude compile time
    first_chunk = 0
    done = start_epoch
    while done < end_epoch:
        n = min(chunk_size, end_epoch - done)
        state, metrics = train_chunk(state, batch, num_steps=n)
        # the metrics fetch waits for the chunk, so the timer below measures
        # device work, not the enqueue
        from desmo_tpu import checkpoint as _ckpt

        metrics = {
            k: np.asarray(v) for k, v in _ckpt.device_fetch_tree(metrics).items()
        }
        if not np.isfinite(metrics["total"][-1]):
            # failure detection (SURVEY §5.3): stop at the chunk boundary with
            # the last finite state still checkpointable by the caller
            bad = int(np.argmax(~np.isfinite(metrics["total"])))
            raise FloatingPointError(
                f"non-finite training loss at epoch {done + bad}; "
                "inspect LRs/omega_init or enable profiling.debug_nans"
            )
        if t0 is None:
            t0 = time.perf_counter()
            first_chunk = n
        histories.append(metrics)
        if log is not None:
            for i in range(done, done + n):
                if i % cfg.log_every == 0 or i == end_epoch - 1:
                    j = i - done
                    log(
                        f"Epoch [{i + 1}/{end_epoch}], "
                        f"Rec Loss: {metrics['rec'][j]:.12f}, "
                        f"Spatial ortho loss: {metrics['ortho'][j]:.8f}, "
                        f"L1 loss: {metrics['l1'][j]:.4f} "
                    )
        done += n
        preempt = preemption_requested()
        # surface async-checkpoint failures promptly (ADVICE r3): if the
        # worker already finished, a failed save raises HERE, not only at the
        # next checkpoint submit
        if _ckpt_pending is not None and _ckpt_pending.done():
            _ckpt_pending.result()
            _ckpt_pending = None
        if checkpoint_fn is not None and (
            done % cfg.checkpoint_every == 0 or done == end_epoch or preempt
        ):
            # Async checkpoint: snapshot the state on-device with ONE jitted
            # dispatch (the next chunk donates/overwrites these buffers), then
            # fetch + write on a worker thread so the ~180 ms save overlaps
            # the next chunk's compute instead of stalling the loop.
            snap = _snapshot_tree(state)
            if _ckpt_pending is not None:
                _ckpt_pending.result()  # surface errors; keep writes ordered
            _ckpt_pending = _ckpt_pool().submit(checkpoint_fn, snap, done)
        if preempt:
            if log is not None:
                saved = (
                    "final state checkpointed"
                    if checkpoint_fn is not None
                    else "no checkpoint_fn — state NOT saved"
                )
                log(
                    f"graceful preemption: stopped at epoch {done} "
                    f"(of {end_epoch}); {saved}"
                )
            # consume the latch: the request is honored by THIS fit — a later
            # fit in the same process (retry loops, preset sweeps) must not
            # silently stop after its first chunk
            clear_preemption()
            break
    if _ckpt_pending is not None:
        _ckpt_pending.result()
    wall = time.perf_counter() - t0 if t0 is not None else 0.0
    # The first chunk's steps ran before the timer started (compile excluded).
    steps_timed = (done - start_epoch) - first_chunk
    sps = steps_timed / wall if wall > 0 and steps_timed > 0 else float("nan")
    history = {
        k: np.concatenate([h[k] for h in histories]) for k in histories[0]
    }
    return TrainResult(
        state=state, history=history, steps_per_sec=sps, wall_seconds=wall,
        preempted=done < end_epoch,
    )
