from tpu_dialmpc_torch.envs.base import EnvState, LeanEnvState, StateInfo
from tpu_dialmpc_torch.envs.go2 import UnitreeGo2Env, UnitreeGo2EnvConfig
from tpu_dialmpc_torch.envs.h1 import UnitreeH1Env, UnitreeH1EnvConfig
from tpu_dialmpc_torch.envs.registry import dial_defaults, get_env, list_envs, register_env

__all__ = [
    "EnvState",
    "LeanEnvState",
    "StateInfo",
    "UnitreeGo2Env",
    "UnitreeGo2EnvConfig",
    "UnitreeH1Env",
    "UnitreeH1EnvConfig",
    "dial_defaults",
    "get_env",
    "list_envs",
    "register_env",
]
