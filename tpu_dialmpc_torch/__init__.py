"""tpu_dialmpc_torch — DIAL-MPC in PyTorch, with its physics substep as a
CUDA kernel written by hand for the NVIDIA H100 (sm_90a).

The port mirrors the JAX package `tpu_dialmpc`, module by module, and is held
against it by the tests (`tests/test_torch_*.py`).  At run time it imports
torch and numpy only: models are read from `.npz` files (`assets/`), not
compiled from MJCF.

- `core/`      spline matrices (numpy) and batched quaternion ops
- `dynamics/`  the model container, the plain PyTorch substep chain
               (`fused.py`) and its CUDA kernel (`fused_cuda.py`,
               `csrc/fused_step.cu`), and the physics pipeline (the JAX
               package's XLA path, batched: `kinematics`, `smooth`,
               `linalg`, `collision`, `constraint`, `solver`, `pipeline`)
- `envs/`      the Go2 and H1 environments, their batched rollouts and the
               13-task registry
- `planner/`   the MBDPI planner and the receding-horizon drivers
- `checkpoint.py`, `telemetry/`  checkpoints of the control loop, and its
               JSONL telemetry stream
- `cli/`       `python -m tpu_dialmpc_torch.cli.main run|replay|env-test --task <task>`
"""

import torch

# fp32-exact matmuls and convolutions (no TF32): the counterpart of the JAX
# package's jax_default_matmul_precision="highest" (tpu_dialmpc/__init__.py).
# The planner's softmax-weighted candidate average and the spline maps are
# the places this workload is sensitive to operand rounding.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
