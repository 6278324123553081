"""Nothing the benchmark loads is JAX or the JAX package (compared by whole
top-level name: the port's name begins with the JAX package's), and the
reference loads nothing of the port."""

import subprocess
import sys

from benchmark.harness.cells import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_dialmpc"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_harness_traffic_metrics_and_reference_load_no_jax():
    loaded = _loaded(
        "import glob, importlib, json, os\n"
        "import benchmark.run, benchmark.control\n"
        "from benchmark.harness import cells, correct, loop, program, trace, work\n"
        "from tpu_dialmpc_torch.planner import runner\n"
        "from tpu_dialmpc_torch.envs import registry\n"
        "[json.load(open(p)) for p in glob.glob('benchmark/traffic/*.json')]\n"
        "[importlib.import_module('benchmark.metrics.' + os.path.basename(p)[:-3])"
        " for p in glob.glob('benchmark/metrics/*.py') if not p.endswith('__init__.py')]\n"
        "[importlib.import_module('benchmark.reference.' + os.path.basename(p)[:-3])"
        " for p in glob.glob('benchmark/reference/*.py') if not p.endswith('__init__.py')]\n")
    assert "tpu_dialmpc_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded(
        "import glob, importlib, os\n"
        "[importlib.import_module('benchmark.reference.' + os.path.basename(p)[:-3])"
        " for p in glob.glob('benchmark/reference/*.py') if not p.endswith('__init__.py')]\n"
        "from benchmark.harness import correct\n")
    assert not loaded & (FORBIDDEN | {"tpu_dialmpc_torch"})
