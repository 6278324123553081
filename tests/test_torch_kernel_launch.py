"""torch port: the fused kernel's launch shape and bound, and the entry
points' device, on the CPU.

- `fused_cuda.launch_config`: one warp per sample, each sample's working
  set (`struct Work` of csrc/fused_step.cu) in shared memory; the bytes per
  sample are the struct's (the host build reports its sizeof) for every
  stand-in scene the port builds a kernel for, and each fits a block's
  227 KB.
- `fused_cuda.waves`: a launch's waves, ceil(B / the samples an H100's
  132 SMs hold at once), for the builds of go2_stand and h1_push_crate.
- `fused.count_ops`: the arithmetic of one plain substep, the kernel's
  bound's numerator, against the JAX package's `count_fused_ops` on the
  same stand-in scenes.  Margin, with its reasons: the port counts the
  selects (`where`), which the JAX count cannot see (jnp.where traces into
  a nested jaxpr); the JAX count adds nq + nv + 1 adds that sum the outputs;
  and on H1 the port keeps the sliding crate's position per sample, as the
  kernel computes it, where the JAX graph folds it into constants (1 % of
  the count).
- The port's entry points take the card unless the caller asks for the CPU.
"""

import inspect

import pytest
import torch

from torch_port_helpers import jax_standin_model, port_model_from
from tpu_dialmpc.telemetry import profile
from tpu_dialmpc_torch.dynamics import fused, fused_cuda
from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.envs.go2 import UnitreeGo2Env
from tpu_dialmpc_torch.envs.h1 import UnitreeH1Env
from tpu_dialmpc_torch.planner.dial import MBDPI, DialConfig

SCENES = ("go2_force", "go2_force_crate", "h1_push_crate")
# every stand-in scene the port builds a kernel for
KERNEL_SCENES = SCENES + ("go2_position", "h1_walk", "h1_loco", "h1_2_walk",
                          "go2_pair_kinds_fused")


def _models(scene):
    mp = pytest.MonkeyPatch()
    try:
        jm = jax_standin_model(mp, scene)
    finally:
        mp.undo()
    return jm, port_model_from(jm)


def _defines(tm):
    spec = fused.DerivedSpec(torso_body=1)
    return fused_cuda.pack_model(tm, fused._meta(tm), spec)[0]


# (bytes per sample, samples per SM by shared memory) of each task's build,
# and its waves at B = 1, 2049 (go2_stand's rollouts) and 8193
# (h1_push_crate_n8192's) on an H100 (132 SMs): 28 x 132 = 3696 and
# 16 x 132 = 2112 samples a wave (tests/test_torch_cuda.py holds the card's
# occupancy, registers included, against these)
WAVES = {"go2_stand": (7504, 28, {1: 1, 2049: 1, 8193: 3}),
         "h1_push_crate": (14224, 16, {1: 1, 2049: 1, 8193: 4})}


@pytest.mark.parametrize("task,B", [(t, b) for t in WAVES for b in (1, 2049, 8193)])
def test_waves_per_launch_follow_the_launch_config(task, B):
    env = get_env(task, device="cpu", fused="on")
    defines = fused_cuda.kernel_sizes(env.model, fused._meta(env.model), env._fused_spec())[0]
    nbytes, per_sm, want = WAVES[task]
    assert fused_cuda.samples_per_sm(*fused_cuda.launch_config(defines)) == per_sm
    assert fused_cuda.work_bytes(defines) == nbytes
    assert fused_cuda.waves(B, per_sm * 132) == want[B] == -(-B // (per_sm * 132))


@pytest.mark.parametrize("scene", SCENES)
def test_count_ops_matches_the_jax_count(scene):
    jm, tm = _models(scene)
    want = profile.count_fused_ops(jm)["arith_ops_per_substep"]
    no_select = fused.count_ops(tm, exclude=("where",))
    assert abs(no_select + tm.nq + tm.nv + 1 - want) <= 0.01 * want, (no_select, want)
    total = fused.count_ops(tm)
    assert no_select < total <= 1.1 * want, (total, want)


@pytest.mark.parametrize("scene", KERNEL_SCENES)
def test_launch_config_fits_shared_memory(scene, tmp_path):
    _, tm = _models(scene)
    defines = _defines(tm)
    nbytes, spb = fused_cuda.launch_config(defines)
    assert nbytes == fused_cuda.work_bytes(defines) and nbytes % 4 == 0
    assert spb * nbytes <= fused_cuda.SMEM_PER_BLOCK and 1 <= spb <= 4
    assert defines["FS_SPB"] == spb
    # the launch bound: 16 warps an SM, or the blocks its shared memory holds
    assert defines["FS_MIN_BLOCKS"] == min(fused_cuda.samples_per_sm(nbytes, spb) // spb, 16 // spb)
    # the host build of the source reports the same struct size and shape
    lib, _, _ = fused_cuda.build_library(tm, fused._meta(tm), fused.DerivedSpec(torso_body=1),
                                         host=True, out_dir=tmp_path)
    info = lib.launch_info()
    assert (info["bytes_per_sample"], info["samples_per_block"]) == (nbytes, spb)


def test_h1_build_holds_16_samples_an_sm_at_4_a_block():
    """H1 push-crate's working set fits 4 samples a block in 4 blocks an SM
    (4 x (4 x 14,336 + 1,024 reserved) B = the SM's 228 KB), so at up to
    128 registers a thread its SMs hold 16 samples: B=8193 in 4 waves."""
    _, tm = _models("h1_push_crate")
    defines = _defines(tm)
    nbytes, spb = fused_cuda.launch_config(defines)
    assert nbytes <= 14336 and spb == 4 and defines["FS_MIN_BLOCKS"] == 4
    assert fused_cuda.samples_per_sm(nbytes, spb, registers=128) == 16
    assert fused_cuda.samples_per_sm(nbytes, spb, registers=129) == 12
    assert fused_cuda.waves(8193, 16 * 132) == 4


def test_launch_config_picks_the_most_samples_per_sm_and_raises_beyond_a_block():
    _, tm = _models("h1_push_crate")
    defines = _defines(tm)
    nbytes, spb = fused_cuda.launch_config(defines)

    def per_sm(k):
        blocks = fused_cuda.SMEM_PER_SM // (k * nbytes + fused_cuda.SMEM_RESERVED_PER_BLOCK)
        return k * min(blocks, fused_cuda.MAX_BLOCKS_PER_SM)

    assert all(per_sm(spb) >= per_sm(k) for k in range(1, 5))
    too_big = dict(defines, FS_NCROW=defines["FS_NCROW"] * 40, FS_NJ=defines["FS_NJ"] * 40)
    with pytest.raises(ValueError):
        fused_cuda.launch_config(too_big)


def test_term_lists_hold_rows_past_the_crate_models():
    """Term lists for 40 single-dof rows and 600 contact rows of up to 12
    dofs each: every term decodes to a row holding both dofs at the places
    it names, each entry's and each dof's rows come in row order, and none
    is missed."""
    nv, rng = 26, torch.Generator().manual_seed(0)
    rows = [[int(torch.randint(nv, (1,), generator=rng))] for _ in range(40)]
    for _ in range(600):
        n = int(torch.randint(1, 13, (1,), generator=rng))
        rows.append(sorted(torch.randperm(nv, generator=rng)[:n].tolist()))
    ents, hterms, gterms = fused_cuda._tables(nv, rows)
    assert sorted(ents) == [(i, j) for i in range(nv) for j in range(i + 1)]
    for (i, j), terms in zip(ents, hterms):
        got = [(u & 0xFFFF, rows[u & 0xFFFF][(u >> 16) & 0xFF], rows[u & 0xFFFF][u >> 24])
               for u in terms]
        want = [r for r, dofs in enumerate(rows) if i in dofs and j in dofs]
        assert [r for r, _, _ in got] == want, (i, j)
        assert all((a, b) == (i, j) for _, a, b in got), (i, j)
    for d, terms in enumerate(gterms):
        assert [u & 0xFFFF for u in terms] == [r for r, dofs in enumerate(rows) if d in dofs]
        assert all(rows[u & 0xFFFF][u >> 16] == d for u in terms)
    with pytest.raises(ValueError):
        fused_cuda._tables(2, [[0]] * ((1 << 16) + 1))


def test_entry_points_default_to_the_card():
    for fn in (get_env, UnitreeGo2Env.__init__, UnitreeH1Env.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():  # no CPU fallback: the first allocation raises
        for task in ("go2_stand", "h1_push_crate"):
            with pytest.raises((AssertionError, RuntimeError)):
                get_env(task)


@pytest.mark.parametrize("task", ["go2_stand", "h1_push_crate"])
def test_cpu_when_asked(task):
    env = get_env(task, device="cpu")
    state = env.reset()
    assert env.device == torch.device("cpu")
    assert state.pipeline.qpos.device.type == "cpu"
    assert MBDPI(DialConfig(Nsample=4, Hsample=4, Hnode=2), env).device == torch.device("cpu")


def test_samples_per_sm_takes_registers_and_the_warp_cap():
    """An SM's registers (4 sub-partitions of 16K, 256 to a warp at a time)
    and its 64 warps cap the samples it holds, besides its shared memory
    (the occupancies the card reported for builds of 96-128 registers);
    ptxas' count is read from a card build's log (none in a host build's)."""
    assert fused_cuda.samples_per_sm(16856, 1) == 13
    assert fused_cuda.samples_per_sm(16856, 1, registers=128) == 13  # 4 warps a partition
    assert fused_cuda.samples_per_sm(16856, 1, registers=129) == 12  # 3 of 4352 registers
    assert fused_cuda.samples_per_sm(9588, 2, registers=109) == 16  # not 18: 4 a partition
    assert fused_cuda.samples_per_sm(12020, 3, registers=112) == 15
    assert fused_cuda.samples_per_sm(7472, 4, registers=96) == 20  # 5 warps a partition
    assert fused_cuda.samples_per_sm(1024, 4) == 64  # the warp cap, not 32 blocks of 4
    log = ("ptxas info    : Compiling entry function '_Z17fused_step_kernelPK10FusedModel' "
           "for 'sm_90a'\nptxas info    : Function properties for _Z17fused_step_kernelPK10"
           "FusedModel\n    96 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 118 registers, used 0 barriers\n")
    assert fused_cuda.ptxas_usage(log) == dict(registers=118, stack_frame=96, spill_stores=0,
                                               spill_loads=0)
    assert fused_cuda.ptxas_usage("")["registers"] == 0
