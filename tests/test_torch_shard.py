"""torch port, the sample-parallel planner (tpu_dialmpc_torch/shard/) on the
CPU, against the JAX package's ShardedMBDPI and MBDPI.

The JAX planners run in this process on the 8-device fake CPU mesh that
tests/conftest.py sets up.  The port's ShardedMBDPI runs in 2, 3 and 4
processes spawned by `shard.distributed.run_group`, under gloo, on the CPU;
they import torch and the port only (tests/torch_shard_ranks.py).  The
groups start in threads when the module's first test asks for them, so
they run while XLA compiles the JAX references.  Each group has a join
timeout of 60 s, after which its processes are killed.

Inputs are float64 and made with numpy from a seed.  Tolerances:
- the stub (linear dynamics) and the port's own draw: 1e-12, the same
  formulas summed in another order (per-rank partials, then the reduce);
- the go2_stand stand-in on the physics pipeline (fused="off"), N8/H4,
  one substep: 1e-10, the pipeline's factorisation order against the JAX
  package's (test_torch_slice.py holds the unsharded step at 1e-10).
"""

import dataclasses
import multiprocessing
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

import torch_shard_ranks as ranks
from stub_env import StubFusedEnv
from torch_port_helpers import ASSETS, TorchStubEnv
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.planner import dial as jdial
from tpu_dialmpc.shard import ShardedMBDPI as JShardedMBDPI
from tpu_dialmpc.shard import make_mesh as jmake_mesh
from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
from tpu_dialmpc_torch.shard import ShardedMBDPI, distributed, make_mesh, sample_sharding
from tpu_dialmpc_torch.shard.mesh import sample_blocks

JOIN_TIMEOUT_S = 60.0
WORLDS = (2, 3, 4)
NU = 4  # the stub's


def _rng(seed):
    return np.random.default_rng(seed)


def _stub_inputs(seed):
    r = _rng(seed)
    Y = r.uniform(-0.5, 0.5, (ranks.STUB["Hnode"] + 1, NU))
    noise = r.normal(size=(ranks.STUB["Nsample"], ranks.STUB["Hnode"] + 1, NU))
    return dict(Y=Y, scale=np.full(ranks.STUB["Hnode"] + 1, 0.3), noise=noise)


def _anchor_inputs():
    """The anchor at the stub's optimum (u = 1 holds qpos at 1), wide noise:
    the clipped candidates score far below it, so it takes most weight."""
    r = _rng(7)
    Y = np.full((ranks.STUB["Hnode"] + 1, NU), 0.99)
    noise = r.normal(size=(ranks.STUB["Nsample"], ranks.STUB["Hnode"] + 1, NU))
    return dict(Y=Y, scale=np.full(ranks.STUB["Hnode"] + 1, 1.0), noise=noise)


def _own_inputs():
    r = _rng(11)
    return dict(seed=5, Y=r.uniform(-0.5, 0.5, (ranks.OWN["Hnode"] + 1, NU)),
                scale=np.full(ranks.OWN["Hnode"] + 1, 0.4))


def _go2_inputs():
    r = _rng(3)
    Y = r.uniform(-0.3, 0.3, (ranks.GO2["Hnode"] + 1, 12))
    noise = r.normal(size=(ranks.GO2["Nsample"], ranks.GO2["Hnode"] + 1, 12))
    return dict(Y=Y, scale=0.5 ** np.arange(ranks.GO2["Hnode"], -1, -1), noise=noise)


CONTROL = dict(seed=9, Y0=_rng(13).uniform(-0.5, 0.5, (ranks.STUB["Hnode"] + 1, NU)),
               n_diffuse=3)
SCORE_STDS = ("sample", "time")


def _specs(world):
    """The cases each group runs, in order; the keys of `_index`."""
    specs = []
    if world in (2, 4):
        specs += [("stub", dict(cfg=dict(score_std=s, diag_states=True), **_stub_inputs(1)))
                  for s in SCORE_STDS]
        specs += [("stub", dict(cfg=dict(diag_states=True), **_anchor_inputs()))]
    specs += [("own", _own_inputs())]
    if world == 2:
        specs += [("control", dict(CONTROL)), ("go2", _go2_inputs())]
    return specs


def _index(world):
    names = []
    if world in (2, 4):
        names += [f"stub-{s}" for s in SCORE_STDS] + ["anchor"]
    names += ["own"]
    if world == 2:
        names += ["control", "go2"]
    return {n: i for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every world size's group, started at once in threads: a future each,
    resolving to every rank's case results."""
    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {}
    for w in WORLDS:
        store = tmp_path_factory.mktemp(f"rdzv{w}") / "store"
        futures[w] = pool.submit(distributed.run_group, ranks.cases, w, (_specs(w),),
                                 device="cpu", timeout_s=JOIN_TIMEOUT_S,
                                 address=f"file://{store}")
    yield futures
    pool.shutdown(wait=True)


def _group(groups, world, case):
    return [rank_out[_index(world)[case]] for rank_out in groups[world].result()]


def _close(got, want, atol, where):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol, err_msg=where)


def _jax_out(y, info):
    out = {"Ybar": np.asarray(y)}
    out.update({f: np.asarray(getattr(info, f)) for f in ranks.INFO_FIELDS})
    return out


def _jax_stub(planner_cls, cfg_kw, inputs):
    cfg = jdial.DialConfig(**dict(ranks.STUB, **cfg_kw))
    env = StubFusedEnv()
    mb = planner_cls(cfg, env, jmake_mesh()) if planner_cls is JShardedMBDPI \
        else planner_cls(cfg, env)
    fn = jax.jit(lambda s, Y, sc, n: mb.reverse_once(s, None, Y, sc, noise=n))
    return _jax_out(*fn(env.reset(), jnp.asarray(inputs["Y"]), jnp.asarray(inputs["scale"]),
                        jnp.asarray(inputs["noise"])))


def test_sample_blocks_are_contiguous_and_even():
    for n, w in ((16, 2), (13, 3), (13, 4), (3, 4), (2048, 2)):
        blocks = sample_blocks(n, w)
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        sizes = [hi - lo for lo, hi in blocks]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    mesh = make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.shape) == (1, 0, {"dcn": 1, "sample": 1})
    assert sample_sharding(mesh, 13) == slice(0, 13)
    with pytest.raises(ValueError, match="process group"):
        make_mesh(n_devices=2, device="cpu")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("score_std", SCORE_STDS)
def test_injected_noise_matches_jax_sharded_and_single(groups, world, score_std):
    """Both score_std modes with diag_states: every rank's Ybar and info equal
    JAX's ShardedMBDPI (8-device mesh) and MBDPI to 1e-12."""
    cfg_kw = dict(score_std=score_std, diag_states=True)
    inputs = _stub_inputs(1)
    want_sharded = _jax_stub(JShardedMBDPI, cfg_kw, inputs)
    want_single = _jax_stub(jdial.MBDPI, cfg_kw, inputs)
    assert want_sharded["qbar"].shape == (ranks.STUB["Hsample"] + 1, NU)
    for rank, got in enumerate(_group(groups, world, f"stub-{score_std}")):
        for f in ("Ybar",) + ranks.INFO_FIELDS:
            _close(got[f], want_sharded[f], 1e-12, f"rank {rank} {f} vs JAX ShardedMBDPI")
            _close(got[f], want_single[f], 1e-12, f"rank {rank} {f} vs JAX MBDPI")


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_own_draw_gives_the_single_device_candidates(groups, world):
    """The port's own generator, Nsample=13 (uneven blocks on 2-4 ranks): the
    same Ybar and info as the port's MBDPI from the same seed."""
    kw = _own_inputs()
    want = ranks.own_draw(MBDPI, None, **kw)
    if world == 1:
        outs = [ranks.own_draw(ShardedMBDPI, make_mesh(device="cpu"), **kw)]
    else:
        outs = _group(groups, world, "own")
    assert len(outs) == world
    for rank, got in enumerate(outs):
        for f in ("Ybar", "rews", "weights", "ess"):
            _close(got[f], want[f], 1e-12, f"world {world} rank {rank} {f}")


def test_improve_chain_through_make_control_step(groups):
    """make_control_step on 2 ranks: the executed step, the shift and an
    improve chain of 3 iterations from the shared generator; infos.rews
    (Ndiffuse, Nsample+1) on every rank, all equal to MBDPI's."""
    want = ranks.control_step(MBDPI, None, **CONTROL)
    for rank, got in enumerate(_group(groups, 2, "control")):
        assert got["rews"].shape == (CONTROL["n_diffuse"], ranks.STUB["Nsample"] + 1)
        for f in ("Ybar", "rews", "qpos"):
            _close(got[f], want[f], 1e-12, f"rank {rank} {f}")


@pytest.mark.parametrize("world", [2, 4])
def test_anchor_enters_each_global_sum_once(groups, world):
    """The anchor holds most of the weight here, so an anchor added inside
    each rank's partial sums (world times) would move every output far past
    the tolerance: the weights sum to 1, the anchor's slot is its own
    reward, and Ybar equals the single-device planner's."""
    want = _jax_stub(jdial.MBDPI, dict(diag_states=True), _anchor_inputs())
    assert want["weights"][-1] > 0.3
    for rank, got in enumerate(_group(groups, world, "anchor")):
        _close(got["weights"].sum(), 1.0, 1e-12, f"rank {rank} sum of weights")
        _close(got["rews"][-1], got["rew_Ybar"], 0.0, f"rank {rank} anchor slot")
        for f in ("Ybar", "weights", "rews", "qbar", "ess"):
            _close(got[f], want[f], 1e-12, f"rank {rank} {f}")


def test_go2_standin_on_two_ranks_matches_jax_sharded(groups, monkeypatch):
    """go2_stand on the Go2 stand-in with fused="off" (the physics pipeline),
    N8/H4/Hnode2, one substep, injected noise: the port on 2 ranks against
    JAX's ShardedMBDPI on the 8-device mesh, to 1e-10."""
    monkeypatch.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    jenv = jget_env("go2_stand", n_substeps=ranks.GO2_SUBSTEPS, dtype="float64", fused="off")
    port_cfg = ranks.go2_config()
    cfg = jdial.DialConfig(**dataclasses.asdict(port_cfg))
    mb = JShardedMBDPI(cfg, jenv, jmake_mesh())
    inputs = _go2_inputs()
    fn = jax.jit(lambda s, Y, sc, n: mb.reverse_once(s, None, Y, sc, noise=n))
    y, info = fn(jax.jit(jenv.reset)(jax.random.PRNGKey(0)), jnp.asarray(inputs["Y"]),
                 jnp.asarray(inputs["scale"]), jnp.asarray(inputs["noise"]))
    outs = _group(groups, 2, "go2")
    for rank, got in enumerate(outs):
        _close(got["Ybar"], np.asarray(y), 1e-10, f"rank {rank} Ybar")
        _close(got["rews"], np.asarray(info.rews), 1e-10, f"rank {rank} rews")
        _close(got["weights"], np.asarray(info.weights), 1e-10, f"rank {rank} weights")
    np.testing.assert_array_equal(outs[0]["Ybar"], outs[1]["Ybar"])


@pytest.mark.parametrize("world", [1, 2])
def test_captured_sharded_planner_equals_eager_on_gloo_ranks(world, tmp_path):
    """The captured ShardedMBDPI (the CPU stand-in for a CUDA graph, with
    `pick_capture` patched as test_torch_capture.py's fixture does) on 1
    and 2 gloo ranks: every call bit-equal to the eager sharded planner's,
    whole graphs on the stub and env-step graphs on the physics pipeline,
    the generator left alike, and the same bytes all-reduced per call (a
    replay adds what its capture counted).  Unpatched, capture=True on a
    gloo group raises, naming gloo."""
    outs = distributed.run_group(ranks.captured_against_eager, world, device="cpu",
                                 timeout_s=JOIN_TIMEOUT_S, address=f"file://{tmp_path / 's'}")
    for rank, out in enumerate(outs):
        assert "over a gloo process group" in out["raises"], out["raises"]
        assert "not a CUDA device" in out["raises"]
        for name in ("stub own draw", "stub injected", "stub control step", "go2 pipeline"):
            got = out[name]
            where = f"rank {rank} of {world}, {name}"
            assert got["captured"] and got["whole"] == (name != "go2 pipeline"), where
            assert got["equal"] == [True] * ranks.CAPTURED_CALLS, where
            assert got["same_generator"], where
            assert got["captured_bytes"] == got["eager_bytes"], where
            assert min(got["eager_bytes"]) > 0, where
        # a graph per unit: reverse_once (stub), the control step, and the
        # pipeline's rollout step at the block + 1
        assert out["captures"] == [1, 1, 1, 1], where


# ---- the bootstrap: rendezvous, barriers, timeouts, no fallback ----


def test_initialize_reads_torchrun_env_and_is_idempotent(tmp_path, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", distributed.free_address().rsplit(":", 1)[1])
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        distributed.initialize(device="cpu", timeout_s=30)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        distributed.initialize(device="cpu")  # again: nothing happens
        with pytest.raises(RuntimeError, match="already initialised"):
            distributed.initialize(num_processes=2)
        distributed.barrier("one rank", timeout_s=5)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
        mesh = distributed.make_multihost_mesh(device="cpu")
        assert (mesh.world_size, mesh.rank, mesh.shape) == (1, 0, {"dcn": 1, "sample": 1})
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="uneven devices per host"):
            distributed.make_multihost_mesh(device="cpu")
        env = TorchStubEnv()
        cfg = DialConfig(**ranks.STUB)
        sharded = ShardedMBDPI(cfg, env, mesh)
        kw = _stub_inputs(2)
        got = ranks.injected(ShardedMBDPI, mesh, cfg, env, **kw)
        want = ranks.injected(MBDPI, None, cfg, env, **kw)
        assert sharded.block == slice(0, cfg.Nsample)
        _close(got["Ybar"], want["Ybar"], 1e-12, "one-rank group")
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()


def test_initialize_without_a_coordinator_says_so(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        distributed.initialize(device="cpu")


def test_nccl_failure_raises_and_does_not_fall_back(tmp_path):
    """NCCL asked for where it cannot run (this CPU build, or a CPU device):
    the call raises and leaves no group, gloo or other."""
    with pytest.raises((RuntimeError, ValueError)):
        distributed.initialize(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl",
                               device="cpu", timeout_s=10)
    assert not dist.is_initialized()
    distributed.shutdown()


def test_barrier_names_the_late_rank(tmp_path):
    out = distributed.run_group(ranks.late_to_barrier, 2, (1.0,), device="cpu",
                                timeout_s=JOIN_TIMEOUT_S, address=f"file://{tmp_path / 's'}")
    assert "barrier 'late': rank(s) [1] of 2 did not arrive within 1 s" in out[0]
    assert out[1] == "late"


def test_hung_collective_fails_within_the_join_timeout(tmp_path):
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[0, 1\] of 2 did not finish"):
        distributed.run_group(ranks.hang, 2, device="cpu", timeout_s=5.0,
                              address=f"file://{tmp_path / 's'}")
    assert not multiprocessing.active_children()


def test_a_rank_that_raises_fails_the_group(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed:(.|\n)*rank 1 refuses"):
        distributed.run_group(ranks.fail_on_rank_1, 2, device="cpu",
                              timeout_s=JOIN_TIMEOUT_S, address=f"file://{tmp_path / 's'}")
    assert not multiprocessing.active_children()
