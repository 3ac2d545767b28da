"""POD / SVD initialization, on device.

The reference runs a *full* LAPACK SVD on the host for every case
(``DESMO/cylinder_flow/DESMO-Cylinder.py:197-299``, ``POD_analysis``) — O(n*m^2)
on CPU, the slowest pre-training stage for the 27000x1000 aneurysm case
(SURVEY §3.1). Redesign: for tall matrices (n >> m) use the method
of snapshots — eigendecompose the m x m Gram matrix ``X^T X = V S^2 V^T`` and
recover ``U = X V / S`` — which is two device GEMMs plus a small symmetric
eigensolve, instead of a host round-trip. Results match the reference SVD up
to per-mode sign, which is absorbed by the learnable phi masks.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class PODResult:
    """Rank-r POD of the snapshot matrix X (n, m)."""

    modes: jnp.ndarray  # U[:, :r]  (n, r)
    temporal: jnp.ndarray  # S_r * Vt[:r]  scaled temporal coefficients? see note
    singular_values: jnp.ndarray  # S[:r]
    energy: jnp.ndarray  # full normalized energy spectrum S^2 / sum(S^2)
    reconstruction: jnp.ndarray  # rank-r approximation U_r S_r Vt_r  (n, m)


def _method_of_snapshots(x: jnp.ndarray, precision) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    gram = jnp.dot(x.T, x, precision=precision)  # (m, m)
    evals, v = jnp.linalg.eigh(gram)  # ascending
    evals = evals[::-1]
    v = v[:, ::-1]
    s = jnp.sqrt(jnp.clip(evals, 0.0))
    # guard tiny/zero singular values when inverting
    safe = jnp.where(s > 0, s, 1.0)
    u = jnp.dot(x, v / safe[None, :], precision=precision)
    return u, s, v.T


def pod(
    x,
    r: int,
    method: str = "auto",
    precision=jax.lax.Precision.HIGHEST,
    oversample: int = 8,
    n_iter: int = 2,
    mesh=None,
) -> PODResult:
    """Rank-r POD of X (n, m).

    ``temporal`` follows the reference convention ``Vt[:r, :]`` (unscaled right
    singular vectors, ``CYL:205``); ``reconstruction`` is ``U_r S_r Vt_r``
    (``CYL:208``).

    method: 'auto' (snapshots when n > m), 'snapshots', 'svd' (full
    ``jnp.linalg.svd``, bit-matching the reference up to sign), or
    'randomized' (range-finder sketch, :func:`randomized_pod` — for shapes
    where even the m x m Gram is too expensive). ``oversample``, ``n_iter``
    and ``mesh`` (run the factorization 'space'-sharded over a device mesh)
    apply to 'randomized' only and are ignored by the exact methods.
    """
    x = jnp.asarray(x, jnp.float32)
    n, m = x.shape
    if method == "auto":
        method = "snapshots" if n > m else "svd"
    if method == "randomized":
        return randomized_pod(
            x, r, oversample=oversample, n_iter=n_iter,
            precision=precision, mesh=mesh,
        )
    if method == "snapshots":
        u, s, vt = _method_of_snapshots(x, precision)
    elif method == "svd":
        u, s, vt = jnp.linalg.svd(x, full_matrices=False)
    else:
        raise ValueError(f"unknown POD method {method!r}")
    energy = (s * s) / jnp.sum(s * s)
    u_r, s_r, vt_r = u[:, :r], s[:r], vt[:r, :]
    recon = jnp.dot(u_r * s_r[None, :], vt_r, precision=precision)
    return PODResult(
        modes=u_r,
        temporal=vt_r,
        singular_values=s_r,
        energy=energy,
        reconstruction=recon,
    )


def truncate(x, result: PODResult, r: int, precision=jax.lax.Precision.HIGHEST) -> PODResult:
    """Rank-r views of an existing rank-R factorization (r <= R): the modes and
    singular values are exact prefixes; only the rank-r reconstruction needs
    one cheap GEMM (avoids re-running the decomposition)."""
    if r > result.modes.shape[1]:
        raise ValueError(f"cannot truncate rank-{result.modes.shape[1]} POD to r={r}")
    u_r = result.modes[:, :r]
    s_r = result.singular_values[:r]
    vt_r = result.temporal[:r, :]
    recon = jnp.dot(u_r * s_r[None, :], vt_r, precision=precision)
    return PODResult(
        modes=u_r,
        temporal=vt_r,
        singular_values=s_r,
        energy=result.energy,
        reconstruction=recon,
    )


def pod_relative_error(x, result: PODResult) -> float:
    """Relative Frobenius error of the rank-r POD reconstruction (``CYL:210``)."""
    x = jnp.asarray(x, jnp.float32)
    return float(jnp.linalg.norm(x - result.reconstruction) / jnp.linalg.norm(x))


def rank_sweep(x, max_r: int, method: str = "auto") -> list[tuple[int, float]]:
    """Relative reconstruction error for every rank 1..max_r from ONE
    factorization — the AE script's inline mode-count sweep
    (``DESMO_AE/...py:283-407``, swept to 20 modes)."""
    full = pod(jnp.asarray(x, jnp.float32), max_r, method=method)
    out = []
    for r in range(1, max_r + 1):
        out.append((r, pod_relative_error(x, truncate(x, full, r))))
    return out


def _cholesky_qr2(y: jnp.ndarray, precision) -> jnp.ndarray:
    """Orthonormalize the tall sketch Y (n, k) via two rounds of CholeskyQR.

    Device-friendly replacement for a tall-skinny QR: each round is one row-parallel
    Gram GEMM ``Y^T Y`` (a psum under a 'space'-sharded n axis), one k x k
    Cholesky, and one row-parallel triangular back-substitution applied as a
    GEMM with the k x k inverse — the spatial axis never gathers. One round is
    CholeskyQR (loses orthogonality at cond(Y)^2 * eps); repeating it
    (CholeskyQR2) restores orthogonality to working precision for any sketch
    the power iteration produces."""
    k = y.shape[1]
    eye = jnp.eye(k, dtype=y.dtype)
    for _ in range(2):
        g = jnp.dot(y.T, y, precision=precision)
        # Shifted CholeskyQR (Fukaya et al. sCQR3): a rank-deficient sketch
        # (k > numerical rank, common when the data is exactly low-rank)
        # makes the plain Cholesky NaN out — fp32 rounding in the Gram is
        # O(eps * tr), so a fixed 1e-6 jitter is NOT enough at k ~ 10.
        # Escalate the diagonal shift and keep the smallest that factors
        # finitely (the k x k factorizations are trace-level cheap); the
        # second round restores orthogonality lost to the shift. Null-space
        # columns come out near-zero rather than orthonormal; their B rows
        # then carry ~0 singular values and sort to the tail, leaving the
        # leading r modes untouched.
        tr = jnp.trace(g) / k
        cands = [
            jnp.linalg.cholesky(g + (s * tr) * eye)
            for s in (1e-6, 1e-3, 1e-1)
        ]
        l = cands[-1]
        for li in cands[-2::-1]:
            l = jnp.where(jnp.isfinite(li).all(), li, l)
        y = jnp.dot(y, jnp.linalg.inv(l).T, precision=precision)
    return y


def randomized_pod(
    x,
    r: int,
    oversample: int = 8,
    n_iter: int = 2,
    seed: int = 0,
    precision=jax.lax.Precision.HIGHEST,
    mesh=None,
) -> PODResult:
    """Rank-r POD by a randomized range finder (Halko-Martinsson-Tropp), for
    spatial meshes where the m x m Gram of the method of snapshots — or the
    O(n m^2) it costs to form — is too expensive (n >> 10^6 or m in the
    thousands; the reference tops out at m=2000, ``CHAN:79``).

    Cost is O(n m k) with k = r + oversample << m, all of it GEMMs:
    sketch ``Y = X @ Omega``, ``n_iter`` power iterations ``Y <- X (X^T Y)``
    (each stabilized by :func:`_cholesky_qr2`), then the small k x m
    ``B = Q^T X`` SVD lifts back through Q. Every tall operation is
    row-parallel over the spatial axis, so passing ``mesh`` (a
    ``('space', 'time')`` mesh from ``parallel.make_mesh``) runs the whole
    factorization with X, Q and the returned modes/reconstruction sharded
    ``P('space', ...)``; the only collectives are the psums XLA inserts for
    the k-width Gram/projection reductions.

    ``energy`` is normalized by ``||X||_F^2`` (exact), so the k computed
    entries are true energy fractions, but the spectrum has length k, not m.
    Within the captured subspace the factorization is an exact truncated SVD
    of ``Q Q^T X``, so ``reconstruction == U_r (U_r^T X)`` and the relative
    error can also be computed without materializing it:
    ``sqrt(1 - sum(energy[:r]))`` to sketch accuracy.
    """
    x = jnp.asarray(x, jnp.float32)
    n, m = x.shape
    k = min(m, n, r + oversample)
    if r > k:
        raise ValueError(f"rank r={r} exceeds sketch width k={k}")
    if mesh is not None and n % mesh.shape["space"] == 0:
        # uneven n degrades to replication, same convention as
        # parallel._drop_unfit (JAX rejects uneven shards)
        from jax.sharding import NamedSharding, PartitionSpec as P

        x = jax.device_put(x, NamedSharding(mesh, P("space", None)))

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def factor(x, omega, n_iter):
        y = jnp.dot(x, omega, precision=precision)  # (n, k) sketch
        q = _cholesky_qr2(y, precision)
        for _ in range(n_iter):
            z = jnp.dot(x.T, q, precision=precision)  # (m, k), psum'd
            q = _cholesky_qr2(jnp.dot(x, z, precision=precision), precision)
        b = jnp.dot(q.T, x, precision=precision)  # (k, m), small
        ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
        u = jnp.dot(q, ub, precision=precision)  # (n, k), row-parallel
        fro2 = jnp.sum(jnp.square(x))
        energy = (s * s) / fro2
        recon = jnp.dot(
            u[:, :r] * s[None, :r], vt[:r, :], precision=precision
        )
        return u[:, :r], s[:r], vt[:r, :], energy, recon

    omega = jax.random.normal(jax.random.PRNGKey(seed), (m, k), jnp.float32)
    u_r, s_r, vt_r, energy, recon = factor(x, omega, n_iter)
    return PODResult(
        modes=u_r,
        temporal=vt_r,
        singular_values=s_r,
        energy=energy,
        reconstruction=recon,
    )


def streaming_randomized_pod(
    column_blocks,
    m: int,
    r: int,
    oversample: int = 8,
    n_iter: int = 2,
    seed: int = 0,
    precision=jax.lax.Precision.HIGHEST,
) -> PODResult:
    """Out-of-core :func:`randomized_pod`: the snapshot matrix X (n, m) is
    never materialized — neither in host RAM nor HBM. Only the (n, k) sketch
    is resident (k = r + oversample); snapshots stream through in column
    blocks, each contributing three GEMM shapes:

    * sketch pass:      ``Y += X_b @ Omega_b``         (+ running ||X||_F^2)
    * power pass (x ``n_iter``): ``Y += X_b @ (X_b^T Q)`` — the two GEMMs of
      ``X X^T Q`` fuse into ONE pass because row t of ``X^T Q`` depends only
      on column t
    * projection pass:  ``B_b = Q^T X_b``

    = ``n_iter + 2`` passes over the snapshot files total (the reference
    loads all of X up front and runs LAPACK on it, ``CYL:39-85,197-205`` —
    impossible beyond host RAM).

    ``column_blocks``: zero-argument callable returning a fresh iterator of
    ``(n, b)`` float blocks whose widths sum to ``m`` in snapshot order on
    every call (it is called ``n_iter + 2`` times); wire snapshot files via
    ``io.vtk.iter_snapshot_column_blocks``. ``reconstruction`` is ``None``
    (materializing it would defeat the purpose); the rank-r relative error
    is ``sqrt(1 - sum(energy[:r]))`` as in :func:`randomized_pod`.
    """
    k = min(m, r + oversample)
    if r > k:
        raise ValueError(f"rank r={r} exceeds sketch width k={k}")
    omega = jax.random.normal(jax.random.PRNGKey(seed), (m, k), jnp.float32)

    @jax.jit
    def _sketch(y, fro2, xb, om_b):
        y = y + jnp.dot(xb, om_b, precision=precision)
        return y, fro2 + jnp.sum(jnp.square(xb))

    @jax.jit
    def _power(y, xb, q):
        z = jnp.dot(xb.T, q, precision=precision)  # (b, k)
        return y + jnp.dot(xb, z, precision=precision)

    @jax.jit
    def _project(q, xb):
        return jnp.dot(q.T, xb, precision=precision)  # (k, b)

    y = None
    fro2 = jnp.zeros((), jnp.float32)
    t = 0
    for xb in column_blocks():
        xb = jnp.asarray(xb, jnp.float32)
        if y is None:
            y = jnp.zeros((xb.shape[0], k), jnp.float32)
        y, fro2 = _sketch(y, fro2, xb, omega[t : t + xb.shape[1]])
        t += xb.shape[1]
    if y is None or t != m:
        raise ValueError(f"column blocks covered {t} of m={m} snapshots")
    qr2 = jax.jit(functools.partial(_cholesky_qr2, precision=precision))
    q = qr2(y)
    for _ in range(n_iter):
        y = jnp.zeros_like(q)
        for xb in column_blocks():
            y = _power(y, jnp.asarray(xb, jnp.float32), q)
        q = qr2(y)
    b = jnp.concatenate(
        [_project(q, jnp.asarray(xb, jnp.float32)) for xb in column_blocks()],
        axis=1,
    )
    ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = jnp.dot(q, ub, precision=precision)
    energy = (s * s) / fro2
    return PODResult(
        modes=u[:, :r],
        temporal=vt[:r, :],
        singular_values=s[:r],
        energy=energy,
        reconstruction=None,
    )


def pod_numpy(x: np.ndarray, r: int):
    """Host-side full-SVD oracle, exactly the reference's path (``CYL:199-208``).

    Returns (X_approx, modes, temporal, S_r) like ``POD_analysis``."""
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    x_approx = u[:, :r] @ np.diag(s[:r]) @ vt[:r, :]
    return x_approx, u[:, :r], vt[:r, :], s[:r]


def pod_host(x, r: int) -> PODResult:
    """Rank-r POD with the REFERENCE's exact mode signs: ``np.linalg.svd`` on
    host (``CYL:199-205``), packaged as a :class:`PODResult`.

    Use this whenever POD modes must pair with *frozen* trained masks — e.g.
    importing a reference ``.pt`` checkpoint for inference. The device paths
    (`pod` with method-of-snapshots or ``jnp.linalg.svd``) may flip individual
    mode signs relative to LAPACK-on-host; during *training* a flip is absorbed
    by the learnable phi masks, but at inference with imported phi it silently
    corrupts the reconstruction."""
    x = np.asarray(x, np.float32)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    energy = (s * s) / np.sum(s * s)
    u_r, s_r, vt_r = u[:, :r], s[:r], vt[:r, :]
    recon = (u_r * s_r[None, :]) @ vt_r
    return PODResult(
        modes=jnp.asarray(u_r),
        temporal=jnp.asarray(vt_r),
        singular_values=jnp.asarray(s_r),
        energy=jnp.asarray(energy),
        reconstruction=jnp.asarray(recon),
    )


def sign_align(result: PODResult, reference_modes) -> PODResult:
    """Flip modes (and their temporal rows) whose sign convention disagrees
    with ``reference_modes`` (n, r'); detection = sign of the mode/reference
    inner product. Returns an aligned :class:`PODResult` (reconstruction is
    sign-invariant and reused)."""
    ref = jnp.asarray(reference_modes, jnp.float32)
    r = result.modes.shape[1]
    dots = jnp.sum(result.modes * ref[:, :r], axis=0)  # (r,)
    flip = jnp.where(dots < 0, -1.0, 1.0)
    return PODResult(
        modes=result.modes * flip[None, :],
        temporal=result.temporal * flip[:, None],
        singular_values=result.singular_values,
        energy=result.energy,
        reconstruction=result.reconstruction,
    )


def canonical_signs(result: PODResult) -> PODResult:
    """Deterministic, data-only sign convention: flip each mode so its
    largest-|value| entry is positive (ties resolve to the lowest index via
    argmax). Applied to every non-host POD path the runner wires up
    (``RunConfig.pod_method != 'host'``) so a train -> evaluate round trip
    rebuilds bit-identical mode signs without re-running host LAPACK — the
    eigh/randomized factorizations are deterministic per backend but their
    raw signs are an implementation accident, and frozen phi masks pair with
    the exact signs they trained against (see :func:`pod_host`). The flip is
    absorbed by the matching temporal row, so the reconstruction is reused
    unchanged."""
    idx = jnp.argmax(jnp.abs(result.modes), axis=0)  # (r,)
    picked = jnp.take_along_axis(result.modes, idx[None, :], axis=0)[0]
    flip = jnp.where(picked < 0, -1.0, 1.0)
    return PODResult(
        modes=result.modes * flip[None, :],
        temporal=result.temporal * flip[:, None],
        singular_values=result.singular_values,
        energy=result.energy,
        reconstruction=result.reconstruction,
    )
