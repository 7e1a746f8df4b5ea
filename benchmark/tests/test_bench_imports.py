"""Nothing the harness runs loads JAX or the JAX package, and the
reference loads nothing of the program. Modules are compared by their
top-level name, whole: `futuredet_torch` is not `futuredet_tpu`, though
one name begins with the other's."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import ROOT

BENCH = ROOT / "benchmark"
JAX = {"jax", "jaxlib", "flax", "futuredet_tpu"}


def _loaded(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in "
                        "sys.modules})))"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, check=True)
    return set(json.loads(p.stdout.splitlines()[-1]))


def _imported(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_harness_and_program_load_no_jax():
    mods = _loaded(
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark import harness, system, control, bounds, check\n"
        "from benchmark.loops import stream, train\n"
        "import futuredet_torch.models.detector, futuredet_torch.train.step\n"
        "import futuredet_torch.eval.decode")
    assert "futuredet_torch" in mods and not (mods & JAX)


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import sys; sys.path.insert(0, '.')\n"
                   "import benchmark.reference.nets, "
                   "benchmark.reference.train, benchmark.reference.detect")
    assert not (mods & (JAX | {"futuredet_torch"}))


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        names = _imported(path)
        assert not (names & JAX), path
        if "reference" in path.parts:
            assert "futuredet_torch" not in names, path


def test_whole_names_tell_the_port_from_the_jax_package():
    from benchmark import harness
    saved = dict(sys.modules)
    try:
        sys.modules["futuredet_torch_extra"] = sys.modules[__name__]
        assert harness.banned_modules() == []
        sys.modules["futuredet_tpu.ops"] = sys.modules[__name__]
        assert harness.banned_modules() == ["futuredet_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
