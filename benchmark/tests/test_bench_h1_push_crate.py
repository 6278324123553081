"""The H1 push-crate cell (`h1_push_crate_n8192.queued`) rehearsed on the CPU
at the small size: found by name with its parts, run through `run_cell`
with a correct result; its two new readers, the kernel's waves per step and
the env ops' spans, on hand-built contexts and None on a context without
their counter or spans."""

from types import SimpleNamespace

import pytest

from benchmark.harness import cells, work

CELL = "h1_push_crate_n8192.queued"


def test_the_cell_is_found_with_its_parts():
    found = cells.find_cell(CELL)
    assert found.config["task"] == "h1_push_crate" and found.config["robot"] == "h1"
    assert found.cell["chips"] == 1 and found.traffic["loop"] == "queued"
    pl = found.config["planner"]
    assert (pl["Nsample"], pl["Hsample"], pl["Hnode"], pl["Ndiffuse"]) == (8192, 32, 8, 2)
    assert found.config["env"]["fused"] == "on" and found.config["env"]["n_substeps"] == 8
    names = {m["name"] for m in found.per_layer}
    assert {"kernel_waves_per_step", "env_ops_ms", "fused_kernel_ms",
            "fused_step_roofline"} <= names
    assert not names & {"pd_map_ms", "reward_stack_ms", "env_kernels_load_s"}
    assert [m["name"] for m in found.end_to_end] == ["ctrl_step_ms", "setup_s"]
    # 66 rollout launches at B=8193 and the executed step's, 8 substeps each
    assert work.sample_substeps_per_step(pl, 8) == (8193 * 33 * 2 + 1) * 8


def test_the_scene_is_the_ports_asset():
    frozen = cells.ROOT / cells.find_cell(CELL).config["env"]["scene"]
    asset = cells.ROOT / "tpu_dialmpc_torch" / "assets" / "h1_push_crate.npz"
    assert frozen.read_bytes() == asset.read_bytes()


def test_the_cell_runs_correct_on_the_cpu(small_run):
    res = small_run(CELL, seed=2**33 + 5)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"ctrl_step_ms", "setup_s"}
    assert res["checks"]["start_gap"]["value"] == 0.0


def _counted(waves):
    return SimpleNamespace(traced_steps=4, kernel_launches={"FusedStep.launches": 268,
                                                            "FusedStep.waves": waves})


def test_the_wave_reader_reads_the_counter():
    read = cells.metric_reader("kernel_waves_per_step")
    assert read(_counted(4 * 529)) == pytest.approx(529)
    assert read(SimpleNamespace(traced_steps=4, kernel_launches={"FusedStep.launches": 268})) \
        is None
    assert read(_counted(0)) is None
    assert read(SimpleNamespace(traced_steps=4, kernel_launches={})) is None
    assert read(SimpleNamespace()) is None


ENV_SPANS = {"rollout/ctrl": dict(count=264, device_s=0.004),
             "rollout/reward": dict(count=264, device_s=0.012),
             "rollout/physics": dict(count=264, device_s=4.5)}


def _spans(device):
    return SimpleNamespace(spans={"device": device}, span_steps={"device": 4})


def test_the_env_ops_reader_reads_its_spans():
    read = cells.metric_reader("env_ops_ms")
    assert read(_spans(ENV_SPANS)) == pytest.approx(4.0)
    for path in ("rollout/ctrl", "rollout/reward"):
        assert read(_spans({p: s for p, s in ENV_SPANS.items() if p != path})) is None
    assert read(SimpleNamespace(spans={}, span_steps={})) is None
    assert read(SimpleNamespace()) is None
