"""Nothing the benchmark runs loads the JAX stack or the JAX package, and
its reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pikazoo_tpu"}

PROBE = r"""
import json, sys, importlib.util
from pathlib import Path
sys.path.insert(0, sys.argv[1])
bench = Path(sys.argv[1]) / "benchmark"
import benchmark.harness, benchmark.counts, benchmark.trace, benchmark.layers
import benchmark.calibrate, benchmark.reference.learner
for sub in ("traffic", "metrics"):
    for path in sorted((bench / sub).glob("*.py")):
        spec = importlib.util.spec_from_file_location("probe_" + path.stem.replace(".", "_"), path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
# what the drivers' set-up imports of the program
import pikazoo_tpu_torch, pikazoo_tpu_torch.train.ppo, pikazoo_tpu_torch.train.networks
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_module_of_the_jax_stack_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "pikazoo_tpu_torch" in top
    assert not top & FORBIDDEN, sorted(top & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    found = []
    for path in sorted((BENCH / "reference").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            found += [(path.name, n) for n in names
                      if n.split(".")[0] in FORBIDDEN | {"pikazoo_tpu_torch"}]
    assert not found, found
