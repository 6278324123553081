from tpu_dialmpc_torch.dynamics.model import PhysicsModel, from_numpy_fields, load_model

__all__ = ["PhysicsModel", "from_numpy_fields", "load_model"]
