from tpu_dialmpc_torch.core import rotations, spline

__all__ = ["rotations", "spline"]
