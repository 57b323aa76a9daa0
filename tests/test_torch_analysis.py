"""The port's static analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), and the port's lint.

- Syntax-tree parity of the seven modules. The analyzer differs from the
  reference in three declared places, and ``DIFFERENCES`` applies exactly
  those to the reference's tree before the comparison: the deprecated
  shims it names (``api.DEPRECATED_MODULES``), the paths it checks by
  default (``runner.DEFAULT_PATHS``), and the name in its command line and
  status line (``runner.main``'s ``prog``, ``runner.run``'s status line).
  Each edit must find its target, so the table cannot go stale unseen.
- Both analyzers give the same findings on every ``.py`` under
  ``src/repro`` and ``src/repro_torch``.
- Each flags imports of its own package's deprecated shims.
- The port's lint, run from the repository's root with its baseline
  (fingerprints hold relative paths), exits 0 in process and as
  ``python -m repro_torch.analysis``, with nothing reported for the
  kernel build.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import api as ref_api
from repro.analysis import runner as ref_runner
from repro_torch.analysis import api as port_api
from repro_torch.analysis import runner as port_runner
from repro_torch.analysis.common import load_baseline
from test_torch_sweep import _tree

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
BASELINE = "src/repro_torch/analysis/baseline.txt"


# --------------------------------------------------------------------------
# syntax-tree parity, with the three declared differences
# --------------------------------------------------------------------------
def _assigned(tree, name):
    [node] = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
              and [t.id for t in n.targets if isinstance(t, ast.Name)]
              == [name]]
    return node


def _port_shims(tree):
    """``api.DEPRECATED_MODULES`` names ``repro_torch.*``, keys and
    values."""
    strings = [n for n in ast.walk(_assigned(tree, "DEPRECATED_MODULES"))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert len(strings) == 8
    for n in strings:
        assert n.value.startswith("repro.")
        n.value = n.value.replace("repro.", "repro_torch.")


def _port_paths_and_name(tree):
    """``runner.DEFAULT_PATHS == ("src/repro_torch",)``, and ``prog`` and
    the status line say ``repro_torch.analysis``."""
    node = _assigned(tree, "DEFAULT_PATHS")
    node.value = ast.Tuple([ast.Constant("src/repro_torch")], ast.Load())
    names = [n for n in ast.walk(tree) if isinstance(n, ast.Constant)
             and n.value in ("python -m repro.analysis", "repro.analysis: ")]
    assert len(names) == 2
    for n in names:
        n.value = n.value.replace("repro.analysis", "repro_torch.analysis")


DIFFERENCES = {"analysis/api": _port_shims,
               "analysis/runner": _port_paths_and_name}
MODULES = ["analysis/common", "analysis/api", "analysis/locks",
           "analysis/events", "analysis/runner", "analysis/__init__",
           "analysis/__main__"]


@pytest.mark.parametrize("module", MODULES)
def test_analysis_copy_is_the_reference_module(module, tmp_path):
    ref = SRC / "repro" / f"{module}.py"
    if module in DIFFERENCES:
        tree = ast.parse(ref.read_text())
        DIFFERENCES[module](tree)
        ref = tmp_path / "edited.py"
        ref.write_text(ast.unparse(tree))
    want = _tree(ref, rename=True)
    got = _tree(SRC / "repro_torch" / f"{module}.py", rename=False)
    assert got == want


# --------------------------------------------------------------------------
# behaviour
# --------------------------------------------------------------------------
@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_both_analyzers_find_the_same(package, monkeypatch):
    monkeypatch.chdir(ROOT)
    files = port_runner.iter_py_files([f"src/{package}"])
    assert files == ref_runner.iter_py_files([f"src/{package}"])
    assert len(files) > 40
    for path in files:
        got = [dataclasses.astuple(f)
               for f in port_runner.check_file(path, path)]
        want = [dataclasses.astuple(f)
                for f in ref_runner.check_file(path, path)]
        assert got == want, path


@pytest.mark.parametrize("stmt", [
    "from repro.core.realproc import compare",
    "import repro.core.realproc",
    "from repro.core import realproc",
    "import repro.taskarray.runner_real",
    "from repro.taskarray.runner_sim import SimRunner",
])
def test_each_analyzer_flags_its_own_deprecated_shims(stmt):
    port_stmt = stmt.replace("repro.", "repro_torch.")
    assert [f.rule for f in port_api.check_source(port_stmt)] \
        == [f.rule for f in ref_api.check_source(stmt)] \
        == ["deprecated-import"]
    assert port_api.check_source(stmt) == []
    # the shims themselves are exempt by path
    assert port_api.check_source(
        port_stmt, path="src/repro_torch/core/realproc.py") == []


def test_port_lint_is_clean_with_its_baseline(monkeypatch):
    monkeypatch.chdir(ROOT)
    out = io.StringIO()
    code = port_runner.run(None, baseline=BASELINE, out=out)
    assert code == 0, out.getvalue()
    assert "repro_torch.analysis: OK" in out.getvalue()
    entries = load_baseline(BASELINE)
    assert len(entries) == 3
    assert not [fp for fp in entries if "kernels/build.py" in fp]
    build = "src/repro_torch/kernels/build.py"
    assert port_runner.check_file(build, build) == []


def test_port_lint_command_line_exits_0():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--baseline",
         BASELINE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_port_lint_fails_on_a_leaking_spawn(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import subprocess

        def compile_all(commands):
            procs = [subprocess.Popen(c) for c in commands]
            return [p.wait() for p in procs]
    """))
    out = io.StringIO()
    assert port_runner.run([str(bad)], out=out) == 1
    assert "popen-teardown" in out.getvalue()
