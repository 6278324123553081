from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI, ReverseInfo

__all__ = ["DialConfig", "MBDPI", "ReverseInfo"]
