"""PyTorch/CUDA port of the A1 convex-MPC engine.

The JAX package ``a1_qp_mpc_controller_tpu`` is the reference; this
package mirrors its layout (``config``, ``types``, ``utils/``,
``models/``, ``ops/``, ``control/``, ``sim/``, ``parallel/``) with a
written-out leading batch dimension in place of ``vmap``. The solver
kernels of the batched tick are hand-written CUDA for Hopper
(``csrc/``, bound in ``ops/kernels.py``).

Every float32 matrix product stays exact float32: the fused ADMM was
never measured to meet OSQP tolerances at reduced precision, and on the
card the trap is TF32 (the JAX package forces its own f32-exact default
in the same spirit).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
