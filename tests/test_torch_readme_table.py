"""torch port, tpu_dialmpc_torch/tools/readme_table.py: README's
port-numbers block matches the port's committed artifacts (--check), the
JAX generator and the port's leave each other's block and artifacts alone,
and a bench row whose budget is the Go2's scaled to another robot
(budget_basis "go2-proxy") shows no budget verdict but a footnote.
Pure file I/O.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from tpu_dialmpc.tools import readme_table as jtable
from tpu_dialmpc_torch.tools import readme_table as table

ROOT = Path(__file__).resolve().parent.parent


def test_port_block_matches_artifacts():
    p = subprocess.run(
        [sys.executable, "-m", "tpu_dialmpc_torch.tools.readme_table", "--check"],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
    )
    assert p.returncode == 0, p.stderr
    text = (ROOT / "README.md").read_text()
    assert "BEGIN GENERATED: port-numbers" in text and table.END in text
    assert not jtable.BEGIN_RE.search(table.render(str(ROOT)))  # not a JAX marker


def _gate(name, passed):
    return {"gate": name, "task": name, "n_steps": 150, "lane": "quick", "seed": 0,
            "measured_at": "2026-01-01T00:00:00Z", "wall_s": 30.0,
            "metrics": {"x_final": 1.0, "z_min": 0.2, "dones_mean": 0.0,
                        "dones_inverted_mean": 0.0, "dones_joint_mean": 0.01,
                        "dones_height_mean": 0.0},
            "checks": [{"metric": "x_final", "op": ">", "threshold": 0.8, "measured": 1.0,
                        "passed": passed}],
            "passed": passed, "device": "card", "power_limit": "700.00 W"}


def test_each_generator_keeps_to_its_own_block_and_artifacts(tmp_path):
    """A root with the JAX package's QUALITY_r05.json and the port's
    QUALITY_TORCH_QUICK_r06.json: the JAX generator still reads r05, the
    port's reads r06, and the port's apply leaves the JAX block (and
    everything outside its own) byte-identical."""
    for name in ("QUALITY_r05.json", "BENCH_LAST_GOOD.json"):
        shutil.copy(ROOT / name, tmp_path / name)
    doc = {"artifact": "quality", "lane": "quick", "platform": "cuda", "device": "card",
           "power_limit": "700.00 W", "wall_s": 60.0, "gates": [_gate("go2_trot", False)]}
    (tmp_path / "QUALITY_TORCH_QUICK_r06.json").write_text(json.dumps(doc))
    assert jtable._latest_quality(str(tmp_path))[0] == "QUALITY_r05.json"
    assert table._latest_quality(str(tmp_path))[0] == "QUALITY_TORCH_QUICK_r06.json"

    jax_block = jtable.render(str(tmp_path))
    before = (f"# t\n\n{jax_block}\n\nport:\n\n<!-- BEGIN GENERATED: port-numbers (old) -->\n"
              f"old\n{table.END}\ntail\n")
    readme = tmp_path / "README.md"
    readme.write_text(before)
    assert table.apply(str(readme), root=str(tmp_path)) == 0
    after = readme.read_text()
    assert after.startswith(f"# t\n\n{jax_block}\n\nport:\n\n") and after.endswith("\ntail\n")
    assert "QUALITY_TORCH_QUICK_r06.json" in after and "| go2_trot | 150 |" in after
    assert "x_final 1 (needs > 0.8)" in after and "card at 700.00 W" in after
    assert table.apply(str(readme), check=True, root=str(tmp_path)) == 0
    # the JAX block of the rewritten file is still the JAX generator's
    m = jtable.BEGIN_RE.search(after)
    assert after[m.start():after.index(jtable.END) + len(jtable.END)] == jax_block


def test_go2_proxy_budget_renders_a_footnote(tmp_path):
    bench = {"metric": "go2_stand_reverse_once_ms_N2048_H20_sub8", "value": 70.0,
             "unit": "ms/iteration", "vs_baseline": 0.143, "budget_basis": "go2",
             "platform": "cuda", "device": "card", "power_limit": "700.00 W",
             "measured_at": "2026-01-01T00:00:00Z",
             "extra": [{"metric": "h1_push_crate_reverse_once_ms_N2048_H32_sub8",
                        "value": 200.0, "unit": "ms/iteration", "vs_baseline": 0.079,
                        "budget_basis": "go2-proxy", "platform": "cuda"}]}
    (tmp_path / table.BENCH_FILE).write_text(json.dumps(bench))
    block = table.render(str(tmp_path))
    assert "| go2_stand_reverse_once_ms_N2048_H20_sub8 | 70 | ms/iteration | 0.143 |" in block
    assert "| h1_push_crate_reverse_once_ms_N2048_H32_sub8 | 200 | ms/iteration | — ¹ |" in block
    assert "¹ The budget of this row is the Go2's" in block
    assert "h1_push_crate_reverse_once_ms_N2048_H32_sub8 vs_baseline 0.079" in block
