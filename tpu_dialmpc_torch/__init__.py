"""tpu_dialmpc_torch — DIAL-MPC in PyTorch, with its physics substep as a
CUDA kernel written by hand for the NVIDIA H100 (sm_90a).

The port mirrors the JAX package `tpu_dialmpc`, module by module, and is held
against it by the tests (`tests/test_torch_*.py`).  At run time it imports
torch and numpy only: models are compiled from MJCF without mujoco
(`dynamics/mjcf.py`) or read from `.npz` files (the stand-ins' in `assets/`).

- `core/`      spline matrices (numpy) and batched quaternion ops
- `dynamics/`  the model container, the plain PyTorch substep chain
               (`fused.py`) and its CUDA kernel (`fused_cuda.py`,
               `csrc/fused_step.cu`), and the physics pipeline (the JAX
               package's XLA path, batched: `kinematics`, `smooth`,
               `linalg`, `collision`, `constraint`, `solver`, `pipeline`)
- `envs/`      the Go2 and H1 environments (with `randomize_tasks`' command
               redraws), their batched rollouts and the 13-task registry
- `planner/`   the MBDPI planner and the receding-horizon drivers, and the
               cost-based planner over generic systems (`cost_dial.py`:
               `CostDialMPC`, reached as a library)
- `systems/`   the generic systems for it: `InvertedPendulum`, `Cartpole`,
               `LeggedRobot` (the physics pipeline)
- `checkpoint.py`, `telemetry/`  checkpoints of the control loop; its JSONL
               telemetry stream (the native C++ sink, `csrc/telemetry_sink.cpp`,
               or the Python writer); the profiler and roofline
               (`profile.py`, with the fp32 microbench kernel
               `csrc/fp32_peak.cu`)
- `shard/`     the sample-parallel planner on torch.distributed
               (`ShardedMBDPI`, one process per rank) and its scaling reports
- `bench.py`   the benchmark rows in the JAX package's schema
- `tools/`     the feet IK and settle probe (`ik.py`)
- `cli/`       `python -m tpu_dialmpc_torch.cli.main
               run|replay|plot|env-test|ik|profile|bench|scaling --task <task>`
"""

import torch

# fp32-exact matmuls and convolutions (no TF32): the counterpart of the JAX
# package's jax_default_matmul_precision="highest" (tpu_dialmpc/__init__.py).
# The planner's softmax-weighted candidate average and the spline maps are
# the places this workload is sensitive to operand rounding.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
