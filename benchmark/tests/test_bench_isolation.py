"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from benchmark import harness

BENCH = harness.BENCH


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_loaded({"gnerf_tpu_torch": 1, "gnerf_tpu_torch.ops": 1,
                                     "jaxtyping": 1, "numpy": 1}) == []
    assert harness.forbidden_loaded({"gnerf_tpu": 1}) == ["gnerf_tpu"]
    assert harness.forbidden_loaded({"gnerf_tpu.ops.fused_decoder": 1}) == ["gnerf_tpu"]
    assert harness.forbidden_loaded({"jax": 1, "jaxlib.xla_client": 1, "flax.linen": 1}) == [
        "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("gnerf_tpu_torch", "gnerf_tpu", "jax", "jaxlib",
                                              "flax", "benchmark"), (path.name, name)


def test_no_benchmark_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("gnerf_tpu", "jax", "jaxlib", "flax"), (path, name)


def test_reference_and_harness_load_no_program_and_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.gnerf, benchmark.reference.train, benchmark.harness\n"
            "from benchmark.harness import forbidden_loaded\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'gnerf_tpu_torch'),"
            " forbidden_loaded())" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout.strip()
    assert out == "[] []"


def test_a_run_loads_the_program_but_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import gnerf_infer, harness\n"
            "import gnerf_tpu_torch.infer.server, gnerf_tpu_torch.training.train\n"
            "from benchmark.drivers import orbit, open_loop, train\n"
            "print(harness.forbidden_loaded())" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout.strip()
    assert out == "[]"
