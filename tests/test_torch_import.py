"""The port stands alone: `repro_torch` and ``chip_smoke.py`` import
neither JAX (nor `ml_dtypes`, which ships with it) nor anything of
the JAX package `repro`."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                _forbidden(str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert bad == [], f"{path}: {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.paper\n"
        "assert not any(k in ('jax', 'ml_dtypes')\n"
        "               or k.startswith(('jax.', 'repro.', 'ml_dtypes.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ,
                                  PYTHONPATH=str(REPO / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_paper_track_modules_import_with_jax_blocked():
    """The approximation subsystem, the observability copies, the spec
    linter, the mutation catalog and the Simulator stand alone too."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "from repro_torch import approx, obs\n"
        "from repro_torch.verify import spec, mutate\n"
        "from repro_torch.circuit.simulate import Simulator, simulate\n"
        "from repro_torch.obs import metrics, trace\n"
        "assert approx.fit_budget and approx.measured_max_logit_error\n"
        "assert len(mutate.CATALOG) == 18 and spec.lint_spec\n"
        "assert trace.ENV_FLAG == 'REPRO_TRACE' and metrics.counter\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ,
                                  PYTHONPATH=str(REPO / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_training_modules_import_and_step_with_jax_blocked():
    """The training slice (losses, AdamW, the train step, the trainer, the
    token pipeline, the launcher) stands alone: with JAX and the reference
    blocked it imports and takes one step of a reduced model on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "from repro_torch.launch import train as LT\n"
        "from repro_torch.train import losses, optimizer, trainer\n"
        "from repro_torch.train import train_state\n"
        "from repro_torch.data import tokens\n"
        "from repro_torch.kernels import flash_attention, ssm_scan\n"
        "assert flash_attention.flash_attention_bwd_plain\n"
        "assert ssm_scan.ssm_scan_bwd_plain and losses.softmax_xent\n"
        "assert optimizer.adamw_update and trainer.Trainer\n"
        "assert tokens.TokenPipeline and train_state.make_train_step\n"
        "out = LT.main(['--arch', 'qwen3-0.6b', '--reduced', '--steps',\n"
        "               '1', '--seq-len', '8', '--global-batch', '2',\n"
        "               '--device', 'cpu'])\n"
        "assert out['last_step'] == 0\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ,
                                  PYTHONPATH=str(REPO / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
