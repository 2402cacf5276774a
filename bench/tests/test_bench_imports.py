"""What the harness may load: never JAX or the JAX package (top-level
module names compared whole, since the port's name begins with the JAX
package's), and in the reference nothing of the port either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path):
    """Top-level names of every absolute import in ``path``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(imported(path))
    assert "repro_torch" not in names and not names & FORBIDDEN
    # relative imports stay inside the reference
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, node.module


def test_whole_name_comparison():
    from bench.harness.common import FORBIDDEN as RUNTIME
    assert set(RUNTIME) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_a_run_of_the_cpu_drivers_loads_no_jax():
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "import bench.drivers.decode, bench.drivers.prefill,"
            " bench.drivers.train, bench.harness.program;"
            "import repro_torch.serve.quantized, repro_torch.train.train_state;"
            "from bench.harness.common import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
