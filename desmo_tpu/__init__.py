"""desmo_tpu — a JAX framework for Decomposed Sparse Modal Optimization.

A from-scratch JAX/XLA rebuild of the capabilities of ``amir-cardiolab/DESMO``
(interpretable reduced-order modeling of unsteady flows): learnable spatial
modes expanded through a polynomial + sin/cos/tanh candidate library, paired
with free temporal coefficients, trained with an L1-sparsified reconstruction
objective, then pruned by term energy into a compact interpretable model.

Subpackages
-----------
- ``library``     candidate-term library as precomputed index tables
- ``models``      DESMO, DESMOFourier and autoencoder-latent variants
- ``losses``      reconstruction / orthogonality / sparsity objectives
- ``optim``       torch-parity Adamax + ReduceLROnPlateau as pure JAX state
- ``train``       fully on-device (lax.scan) training loop
- ``pod``         POD/SVD initialization
- ``data``        snapshot-matrix preprocessing transforms
- ``sparsify``    term-energy norms, threshold sweeps, greedy pruning
- ``checkpoint``  run checkpoints + PyTorch ``.pt`` import/export (torch-free)
- ``parallel``    device-mesh sharding of the spatial/temporal axes
- ``io``          VTK snapshot readers (pure Python + native-accelerated)
- ``sr``          post-hoc dynamical-system identification (dz/dt = f(z))
"""

__version__ = "0.1.0"

from desmo_tpu import configs  # noqa: F401
from desmo_tpu.configs import RunConfig, get as get_config  # noqa: F401
