"""torch port, the physics pipeline against the JAX package's, stage by stage
in float64 (tests/torch_physics_cases.py), on the crate-free H1 stand-in
h1_walk (nv 25), each contact kind against the floor."""

import pytest

from torch_physics_cases import *  # noqa: F401,F403 -- the cases, run on this file's scene


@pytest.fixture(scope="module", params=['h1_walk'])
def scene(request):
    return request.param
