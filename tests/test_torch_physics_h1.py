"""torch port, the physics pipeline against the JAX package's, stage by stage
in float64 (tests/torch_physics_cases.py), on the H1 push-crate stand-in:
a 30 kg crate on a slide joint, contact rows that couple the robot's and the
crate's trees."""

import pytest

from torch_physics_cases import *  # noqa: F401,F403 -- the cases, run on this file's scene


@pytest.fixture(scope="module", params=['h1_push_crate'])
def scene(request):
    return request.param
