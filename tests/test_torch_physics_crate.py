"""torch port, the physics pipeline against the JAX package's, stage by stage
in float64 (tests/torch_physics_cases.py), on the Go2 crate stand-in: all
six contact kinds the fused substep has (the torso box, thigh and calf
capsules, foot spheres against the floor and the mocap crate)."""

import pytest

from torch_physics_cases import *  # noqa: F401,F403 -- the cases, run on this file's scene


@pytest.fixture(scope="module", params=['go2_force_crate'])
def scene(request):
    return request.param
