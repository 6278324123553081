"""torch port, tools/ik.py and the CLI's `ik` and `plot`: the feet IK and
the settle probe against the JAX package's `tpu_dialmpc.tools.ik` on the Go2
stand-in, and both subcommands end to end on the CPU.

The JAX tool casts its inputs to float32 (`jnp.float32`, three places); the
comparison runs it with those casts made float64 (its module's `jnp` seen
through a proxy whose `float32` is float64), so that both sides compute in
float64.  Tolerances: 1e-8 on the IK's joint angles (the same Gauss-Newton
steps; the two agree to ~1e-15 here), 1e-9 per physics step on the settle
probe (3 steps: 3e-9; the pipelines agree to ~1e-12 after 3 steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import use_standin_assets
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.tools import ik as jik
from tpu_dialmpc_torch.cli import main as tcli
from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.tools import ik

OFFSET = [0.0, 0.0, -0.03]
SETTLE_STEPS = 3


class _Float64Jnp:
    """jax.numpy with float32 meaning float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def envs():
    mp = pytest.MonkeyPatch()
    use_standin_assets(mp)
    mp.setattr(jik, "jnp", _Float64Jnp())
    yield (jget_env("go2_stand", dtype="float64"),
           get_env("go2_stand", device="cpu", dtype="float64"))
    mp.undo()


def test_solve_feet_ik_matches_jax(envs):
    jenv, tenv = envs
    jq, jres = jik.solve_feet_ik(jenv, OFFSET)
    tq, tres = ik.solve_feet_ik(tenv, OFFSET)
    assert tq.dtype == torch.float64 and tq.shape == (tenv.model.nq,)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-8)
    # the base moved, the feet stayed: residual at rounding level
    assert float(tres) < 1e-6 and float(jres) < 1e-6
    np.testing.assert_allclose(tq[:3].numpy(), np.asarray(tenv._init_q[:3]) + OFFSET,
                               rtol=0, atol=1e-12)
    assert not np.allclose(tq[7:].numpy(), tenv._init_q[7:], atol=1e-3)  # the legs bent


def test_settle_probe_matches_jax(envs):
    jenv, tenv = envs
    jq = jik.settle_probe(jenv, OFFSET, n_steps=SETTLE_STEPS)
    tq = ik.settle_probe(tenv, OFFSET, n_steps=SETTLE_STEPS)
    assert tq.shape == (tenv.model.nq,) and torch.isfinite(tq).all()
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-9 * SETTLE_STEPS)
    assert not np.allclose(tq.numpy(), np.asarray(tenv._init_q), atol=1e-6)  # it moved


@pytest.mark.parametrize("mode", ["ik", "settle"])
def test_cli_ik_runs_on_the_cpu(mode, capsys):
    assert tcli.main(["ik", "--task", "go2_stand", "--device", "cpu", "--mode", mode,
                      "--dz", "-0.03"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    if mode == "ik":
        assert lines[0].startswith("feet-position residual: ")
        assert float(lines[0].split()[2]) < 1e-5
    assert any(l.startswith("base: ") for l in lines)
    assert any(l.startswith("joint angles: ") for l in lines)


def test_cli_plot_draws_a_run_trajectory(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MPLBACKEND", "Agg")
    traj, png = tmp_path / "run.npz", tmp_path / "plots.png"
    assert tcli.main(["run", "--task", "go2_stand", "--device", "cpu", "--nsample", "4",
                      "--hsample", "2", "--substeps", "1", "--n-steps", "2",
                      "--out", str(traj)]) == 0
    assert tcli.main(["plot", "--trajectory", str(traj), "--out", str(png)]) == 0
    assert capsys.readouterr().out.strip().endswith(f"plots saved to {png}")
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and png.stat().st_size > 10_000
