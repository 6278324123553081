from tpu_dialmpc_torch.dynamics.model import (
    PhysicsModel,
    compile_model,
    from_numpy_fields,
    load_model,
    load_scene,
    save_model,
)

__all__ = ["PhysicsModel", "compile_model", "from_numpy_fields", "load_model", "load_scene",
           "save_model"]
