"""Device-mesh sharding of DESMO training.

The reference is strictly single-process / single-GPU (SURVEY §2 preamble:
no torch.distributed anywhere; jobs request ``--gres=gpu:1``). Scaling is
therefore *new capability*, per SURVEY §5.7-5.8:

* The dominant axes are **n** (spatial points — unbounded for larger meshes)
  and **m** (snapshots). We lay them on a 2-D mesh ``('space', 'time')``.
* Row-sharding the spatial axis makes the reconstruction GEMM
  ``A (n, K) @ B (K, m)`` embarrassingly row-parallel; column-sharding time
  splits the temporal parameters. The only communication XLA needs to insert
  is ``psum`` over loss/gradient reductions (MSE, Gram matrix, L1), which
  XLA lowers to the device interconnect's collectives (NCCL all-reduces
  over NVLink on a multi-GPU host).
* Everything goes through ``jax.sharding.NamedSharding`` + jit propagation;
  there is no hand-written collective code to maintain.

Placement rules (by parameter key):

=============  =====================  ==================================
leaf           shape                  PartitionSpec
=============  =====================  ==================================
phi            (r, n)                 (None, 'space')
z              (T, m)                 (None, 'time')   [replicated if small]
z_trig         (3, r, m)              (None, None, 'time')
c, c_trig,     small                  replicated
omega, period
batch x        (n, m)                 ('space', 'time')
batch pod      (n, r)                 ('space', None)
opt moments    like params            like params
=============  =====================  ==================================
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_space: Optional[int] = None, n_time: int = 1, devices=None
) -> Mesh:
    """Build a ('space', 'time') mesh; defaults to all devices on 'space'."""
    devices = list(devices if devices is not None else jax.devices())
    if n_space is None:
        n_space = len(devices) // n_time
    if n_space * n_time != len(devices):
        raise ValueError(
            f"{n_space} x {n_time} mesh does not tile {len(devices)} devices"
        )
    arr = np.array(devices).reshape(n_space, n_time)
    return Mesh(arr, ("space", "time"))


def _param_spec(key: str, shape: tuple[int, ...], m: Optional[int]) -> P:
    if key == "phi":
        return P(None, "space")
    if key in ("z",) and m is not None and shape[-1] == m:
        return P(None, "time")
    if key == "z_trig" and m is not None and shape[-1] == m:
        return P(None, None, "time")
    if key.startswith("ae_"):  # autoencoder MLP weights: replicate
        return P()
    return P()  # c, c_trig, omega, period, trig_period, small z's


def _drop_unfit(spec: P, shape: tuple[int, ...], mesh: Mesh) -> P:
    """Replace mesh axes that do not evenly divide their dimension with
    replication (JAX rejects uneven shards); keeps everything else intact so
    real-data sizes like n=3961 degrade gracefully instead of erroring."""
    entries = list(spec)
    out = []
    for d, ax in enumerate(entries):
        if ax is not None and shape[d] % mesh.shape[ax] != 0:
            out.append(None)
        else:
            out.append(ax)
    return P(*out)


def param_shardings(params: dict, mesh: Mesh, m: Optional[int]) -> dict:
    return {
        k: NamedSharding(
            mesh, _drop_unfit(_param_spec(k, np.shape(v), m), np.shape(v), mesh)
        )
        for k, v in params.items()
    }


def ensemble_param_shardings(params: dict, mesh: Mesh, m: Optional[int]) -> dict:
    """Shardings for the seed-stacked ensemble params (``ensemble.init_params``:
    every leaf carries a leading seed axis). The seed axis is replicated —
    seeds live in the packed term axis, not on devices — and each leaf's remaining axes
    follow the single-seed placement rules (phi rows over 'space', temporal
    coefficients over 'time')."""
    out = {}
    for k, v in params.items():
        shape = np.shape(v)
        base = _param_spec(k, shape[1:], m)
        out[k] = NamedSharding(mesh, _drop_unfit(P(None, *base), shape, mesh))
    return out


def batch_shardings(batch: dict, mesh: Mesh) -> dict:
    specs = {}
    for k, v in batch.items():
        nd = np.ndim(v)
        if k in ("x", "x_padded", "x_hi", "x_lo") and nd == 2:
            specs[k] = P("space", "time")
        elif k == "pod_modes" and nd == 2:
            specs[k] = P("space", None)
        else:
            specs[k] = P()
        if nd:
            specs[k] = _drop_unfit(specs[k], np.shape(v), mesh)
    return {k: NamedSharding(mesh, s) for k, s in specs.items()}


def state_shardings(state, mesh: Mesh, m: Optional[int]):
    """Shardings for a full ``train.TrainState``: optimizer moments follow
    their parameters; scheduler/counters are replicated."""
    p_sh = param_shardings(state.params, mesh, m)
    rep = NamedSharding(mesh, P())

    def like_params(tree):
        return {k: p_sh[k] for k in tree}

    return type(state)(
        params=p_sh,
        opt=type(state.opt)(count=rep, mu=like_params(state.opt.mu), nu=like_params(state.opt.nu)),
        sched=jax.tree.map(lambda _: rep, state.sched),
        epoch=rep,
    )


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    sh = batch_shardings(batch, mesh)
    return {k: jax.device_put(v, sh[k]) for k, v in batch.items()}


def shard_state(state, mesh: Mesh, m: Optional[int]):
    sh = state_shardings(state, mesh, m)
    return jax.tree.map(jax.device_put, state, sh)


def distributed_init(**kwargs) -> None:
    """Multi-host setup (SURVEY §5.8): thin wrapper over
    ``jax.distributed.initialize``. The devices of one host need no setup;
    call this only for multi-process runs — pass the coordinator address
    (process 0's ``host:port``), the process count and this process's id, or
    let a cluster environment JAX detects supply them. All sharding in this
    package then applies unchanged over ``jax.devices()`` spanning hosts."""
    jax.distributed.initialize(**kwargs)


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int) -> np.ndarray:
    """Zero-pad an axis so it divides evenly across mesh shards.

    Zero rows are harmless for DESMO: padded spatial points contribute zero to
    every inner product and reconstruction error, and padded POD-mode rows keep
    effective modes zero there. (MSE denominators change; use only for scaling
    studies, not parity runs.)
    """
    size = x.shape[axis]
    target = math.ceil(size / multiple) * multiple
    if target == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return np.pad(x, pad)
