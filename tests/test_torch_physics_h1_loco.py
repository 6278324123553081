"""torch port, the physics pipeline against the JAX package's, stage by stage
in float64 (tests/torch_physics_cases.py), on the arms-fixed H1 stand-in
h1_loco (nv 17), each contact kind against the floor."""

import pytest

from torch_physics_cases import *  # noqa: F401,F403 -- the cases, run on this file's scene


@pytest.fixture(scope="module", params=['h1_loco'])
def scene(request):
    return request.param
