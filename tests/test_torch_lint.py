"""The port's lint (`repro_torch.lint`), case for case beside
``tests/test_jaxlint.py``: the port's tree is clean, int-domain purity
carries over, each torch rule fires on a minimal reproducer and leaves its
hoisted idiom alone, and the CLI's exit codes."""
import subprocess
import sys
from pathlib import Path

from repro_torch import lint

REPO = Path(__file__).resolve().parent.parent


def _lint_src(src: str, tmp_path, name="mod.py"):
    f = tmp_path / name
    f.write_text(src)
    return lint.lint_file(f, rel=name)


def _rules(findings):
    return [f.rule for f in findings]


def test_port_tree_is_clean():
    assert lint.lint_paths([str(REPO / "src" / "repro_torch")]) == []


def test_int_domain_modules_exist_and_are_checked():
    for m in lint.INT_DOMAIN_MODULES:
        assert (REPO / "src" / m).is_file(), m


def test_int_domain_purity(tmp_path):
    src = ("import numpy as np\n"
           "from torch import nn\n"
           "def f(a, b):\n"
           "    return a / b\n")
    findings = _lint_src(src, tmp_path, name="repro_torch_circuit_ir.py")
    # not an int-domain module name -> nothing fires
    assert findings == []
    d = tmp_path / "repro_torch" / "circuit"
    d.mkdir(parents=True)
    (d / "ir.py").write_text(src)
    findings = lint.lint_paths([str(tmp_path)])
    assert sorted(set(_rules(findings))) == ["int-domain"]
    assert len(findings) == 3            # numpy import, torch import, '/'
    # the scan root may be the package itself: the file's path decides
    assert len(lint.lint_paths([str(tmp_path / "repro_torch")])) == 3


def test_tensor_branch_and_host_syncs_in_compiled(tmp_path):
    src = ("import torch\n"
           "@torch.compile\n"
           "def f(x, y, k: int = 2, *, scale=1.0):\n"
           "    if k > 1:\n"              # a knob: fine
           "        pass\n"
           "    if scale:\n"              # a literal default: fine
           "        pass\n"
           "    if y.sum() > 0:\n"        # tensor: flagged
           "        x = x + 1\n"
           "    while x:\n"               # tensor: flagged
           "        break\n"
           "    n = y.max().item()\n"     # host sync: flagged
           "    return x.cpu(), x.numpy(), x.tolist(), n\n")  # three more
    findings = _lint_src(src, tmp_path)
    assert _rules(findings) == ["sync-in-compiled"] * 6
    assert "tensor parameter(s) y" in findings[0].message
    assert "'.item()'" in findings[2].message


def test_shape_reads_and_knobs_not_flagged(tmp_path):
    src = ("import functools\n"
           "import torch\n"
           "@functools.partial(torch.compile, dynamic=False)\n"
           "def f(q, *, causal=True):\n"
           "    if causal:\n"
           "        q = q * 1\n"
           "    T = q.shape[0]\n"
           "    if q.dim() == 3 and q.size(-1) % 8 and T:\n"
           "        q = q * 2\n"
           "    if q.dtype == torch.bfloat16 or q.numel() > 4:\n"
           "        q = q.float()\n"
           "    return q\n")
    assert _lint_src(src, tmp_path) == []


def test_called_decorator_and_nested_defs_are_scanned(tmp_path):
    src = ("import torch as th\n"
           "@th.compile(fullgraph=True)\n"
           "def f(x, y):\n"
           "    def inner(z):\n"
           "        if y:\n"              # outer tensor in a nested def
           "            return z\n"
           "        return z.item()\n"
           "    return inner(x)\n")
    assert _rules(_lint_src(src, tmp_path)) == ["sync-in-compiled"] * 2


def test_syncs_outside_compiled_not_flagged(tmp_path):
    src = ("import torch\n"
           "def f(x):\n"
           "    if x.sum() > 0:\n"
           "        return x.item()\n"
           "    return x.cpu().numpy().tolist()\n")
    assert _lint_src(src, tmp_path) == []


def test_cli_exit_codes(tmp_path, capsys):
    good = tmp_path / "ok.py"
    good.write_text("x = 1\n")
    assert lint.main([str(good)]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n@torch.compile\ndef f(a):\n    if a:\n"
                   "        return 1\n    return 0\n")
    assert lint.main([str(bad)]) == 1
    assert lint.main([]) == 2
    capsys.readouterr()
    # as a module on the tree, the way the README runs it
    out = subprocess.run([sys.executable, "-m", "repro_torch.lint",
                          str(REPO / "src" / "repro_torch")], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stdout


def test_obs_in_compiled_flagged(tmp_path):
    src = ("import torch\n"
           "from repro_torch.obs import trace as TR\n"
           "from repro_torch.obs import metrics as MT\n"
           "from repro_torch.obs.trace import span\n"
           "@torch.compile\n"
           "def f(x, *, n=2):\n"
           "    with TR.span('bad'):\n"
           "        MT.counter('c').inc()\n"
           "    span('also bad')\n"
           "    return x\n")
    findings = _lint_src(src, tmp_path)
    assert _rules(findings) == ["obs-in-compiled"] * 3
    assert "host-side" in findings[0].message


def test_obs_outside_compiled_not_flagged(tmp_path):
    src = ("import torch\n"
           "from repro_torch.obs import trace as TR\n"
           "@torch.compile\n"
           "def _f_compiled(x):\n"
           "    return x + 1\n"
           "def f(x):\n"
           "    with TR.span('kernels.f'):\n"      # around the call: fine
           "        y = _f_compiled(x)\n"
           "    return y\n")
    assert _lint_src(src, tmp_path) == []


def test_compile_in_loop_flagged(tmp_path):
    src = ("import torch\n"
           "def f(xs):\n"
           "    out = []\n"
           "    for x in xs:\n"
           "        g = torch.compile(lambda v: v + 1)\n"  # fresh a pass
           "        out.append(g(x))\n"
           "    return out\n")
    findings = _lint_src(src, tmp_path)
    assert _rules(findings) == ["compile-in-loop"]
    assert "inside a loop body" in findings[0].message


def test_compile_in_loop_partial_in_while_flagged(tmp_path):
    src = ("import functools\n"
           "from torch import compile as tcompile\n"
           "def f(x):\n"
           "    while x < 3:\n"
           "        h = functools.partial(tcompile, dynamic=True)\n"
           "        x = x + 1\n"
           "    return x\n")
    assert _rules(_lint_src(src, tmp_path)) == ["compile-in-loop"]


def test_compile_and_call_in_function_flagged(tmp_path):
    src = ("import torch\n"
           "def cluster(w, k):\n"
           "    return torch.compile(_kmeans)(w, k)\n")
    findings = _lint_src(src, tmp_path)
    assert _rules(findings) == ["compile-in-loop"]
    assert "traces and compiles again" in findings[0].message


def test_compile_hoisted_idioms_not_flagged(tmp_path):
    # module scope, decorator, lru_cache factory, attribute, a compiled
    # function called in a loop, and Python's own builtin compile
    src = ("import functools\n"
           "import torch\n"
           "_g = torch.compile(lambda v: v + 1)\n"
           "@torch.compile(dynamic=False)\n"
           "def _f(x):\n"
           "    return x * 2\n"
           "@functools.lru_cache(maxsize=None)\n"
           "def _make(k):\n"
           "    return torch.compile(lambda v: v * k)\n"
           "class Step:\n"
           "    def __init__(self):\n"
           "        self._step = torch.compile(self._raw)\n"
           "    def _raw(self, x):\n"
           "        return x\n"
           "def run(xs):\n"
           "    for x in xs:\n"
           "        _g(x)\n"
           "        code = compile('1', 'f', 'eval')\n"
           "    return _make(2)(xs[0])\n")
    assert _lint_src(src, tmp_path) == []
