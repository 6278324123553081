"""Generic-system DIAL-MPC (the reference's commented-out ROS prototype).

Counterpart of `tpu_dialmpc/systems/`: `System` and its quadratic costs,
`InvertedPendulum`, `Cartpole` and `LeggedRobot`, for the cost-based
planner `planner/cost_dial.py`.
"""

from tpu_dialmpc_torch.systems.base import System
from tpu_dialmpc_torch.systems.classic import Cartpole, InvertedPendulum
from tpu_dialmpc_torch.systems.legged import LeggedRobot

__all__ = ["System", "InvertedPendulum", "Cartpole", "LeggedRobot"]
