"""The fused kernel alone, another tree of the repository against this one,
on one card, in turns (other, this, this, other), each run in a process of
its own, on the same inputs: per stand-in build, ptxas' registers, stack
frame and spills, the bytes of shared memory per sample, the samples an SM
holds (the runtime's occupancy), the waves at B = 2049 and 8193, and the
kernel's ms per launch (CUDA events over a run of launches, 8 substeps) at
B = 1, 2049 and 8193; then whether the two trees' outputs are equal to the
bit at each batch size.

    git archive <commit> | tar -x -C build/parent    # build/ is not committed
    python3 tests/fused_kernel_ab_probe.py build/parent [scene ...]

A scene is a model name of tpu_dialmpc_torch/assets or a scene file's path
(default: every stand-in build).  The inputs are chip_smoke.py's for each
scene, made once from fixed seeds and saved under build/."""
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H1_2 = "tests/assets/unitree_h1/mjx_scene_h1_2_walk.xml"
PAIRS = "tests/assets/pairs/mjx_scene_pair_kinds_fused.xml"
# scene -> (chip_smoke.py's input maker, torso body name)
SCENES = {
    "go2_force": ("near_home_inputs", "base"),
    "go2_force_crate": ("crate_inputs", "base"),
    "go2_position": ("servo_inputs", "base"),
    "h1_push_crate": ("h1_crate_inputs", "pelvis"),
    "h1_walk": ("h1_floor_inputs", "pelvis"),
    "h1_loco": ("h1_floor_inputs", "pelvis"),
    H1_2: ("h1_2_floor_inputs", "pelvis"),
    PAIRS: ("pair_kinds_inputs", "base"),
}
BATCHES = {1: 20, 2049: 10, 8193: 5}  # B -> timed launches
INPUTS = ROOT / "build" / "fused_kernel_ab_inputs.pt"


def _model(tree, scene):
    from tpu_dialmpc_torch.dynamics.model import load_model, load_scene

    if scene.endswith(".xml"):
        return load_scene(str(Path(tree) / scene))
    return load_model(str(Path(tree) / "tpu_dialmpc_torch" / "assets" / f"{scene}.npz"))


def make_inputs(scenes):
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import torch

    import chip_smoke

    data = {}
    for scene in scenes:
        maker = getattr(chip_smoke, SCENES[scene][0])
        m = _model(ROOT, scene)
        data[scene] = {B: [t.cpu() for t in maker(m, B, B, "cpu")] for B in BATCHES}
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(data, INPUTS)


def child(tree, out, scenes):
    sys.path.insert(0, str(tree))
    import torch

    import tpu_dialmpc_torch
    from tpu_dialmpc_torch.dynamics import fused, fused_cuda

    assert Path(tpu_dialmpc_torch.__file__).resolve().is_relative_to(Path(tree).resolve())
    dev = torch.device("cuda", 0)
    data = torch.load(INPUTS)
    steps = {}
    for scene in scenes:
        m = _model(tree, scene)
        spec = fused.DerivedSpec(torso_body=m.body_names.index(SCENES[scene][1]),
                                 want_sites=True, want_qfrc_actuator=True)
        steps[scene] = fused_cuda.FusedStep(m, 8, spec)
    with ThreadPoolExecutor(len(steps)) as pool:  # one nvcc each, at once
        list(pool.map(lambda fs: fs.compile(), steps.values()))
    result, outputs = {}, {}
    for scene, fs in steps.items():
        lib = fs.library(dev)
        info = lib.launch_info()
        r = dict(info, log=fs.build_log, ms={})
        for B, n in BATCHES.items():
            args = [t.to(dev) for t in data[scene][B]]
            outputs[(scene, B)] = [t.cpu() for t in fs(*args)]
            fs(*args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(n):
                fs(*args)
            end.record()
            torch.cuda.synchronize()
            r["ms"][B] = start.elapsed_time(end) / n
        result[scene] = r
    torch.save(outputs, out)
    print("RESULT " + json.dumps(result), flush=True)


def main(other, scenes):
    sys.path.insert(0, str(ROOT))
    import torch

    from tpu_dialmpc_torch.dynamics import fused_cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"other": Path(other).resolve(), "this": ROOT}
    make_inputs(scenes)
    runs = []
    for i, side in enumerate(("other", "this", "this", "other")):
        out = ROOT / "build" / f"fused_kernel_ab_{side}{i}.pt"
        proc = subprocess.run([sys.executable, __file__, "--child", str(trees[side]), str(out),
                               *scenes], capture_output=True, text=True)
        line = next((x for x in proc.stdout.splitlines() if x.startswith("RESULT ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-3000:], proc.stderr[-6000:])
            raise SystemExit(f"the {side} run failed (rc={proc.returncode})")
        runs.append((side, json.loads(line[7:]), out))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for scene in scenes:
        for side in ("other", "this"):
            r = next(res[scene] for s, res, _ in runs if s == side)
            use = fused_cuda.ptxas_usage(r["log"])
            per_sm = r["blocks_per_sm"] * r["samples_per_block"]
            waves = {B: fused_cuda.waves(B, per_sm * sms) for B in (2049, 8193)}
            ms = {B: [res[scene]["ms"][str(B)] for s, res, _ in runs if s == side]
                  for B in BATCHES}
            print(f"[{scene}] {side}: {r['bytes_per_sample']} B a sample, "
                  f"{r['samples_per_block']} a block, {per_sm} an SM ({per_sm * sms} on "
                  f"{sms} SMs), waves {waves}; {use['registers']} registers, "
                  f"{use['stack_frame']} B stack, spills {use['spill_stores']}/"
                  f"{use['spill_loads']} B; ms " + ", ".join(
                      f"B={B} {statistics.mean(v):.4f} ({' '.join(f'{x:.4f}' for x in v)})"
                      for B, v in ms.items()), flush=True)
        outs = [torch.load(out) for _, _, out in runs]
        for B in BATCHES:
            same = all(torch.equal(a, b) for o in outs[1:]
                       for a, b in zip(outs[0][(scene, B)], o[(scene, B)]))
            print(f"[{scene}] B={B}: the trees' outputs equal to the bit: {same}", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        main(sys.argv[1], sys.argv[2:] or list(SCENES))
