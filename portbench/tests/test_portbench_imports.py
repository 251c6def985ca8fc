"""Nothing under portbench/ imports jax or the JAX package, nothing under
portbench/reference/ imports the program, and a run loads neither."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "meters_lv2_tpu"}


def _top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports(path):
    names = _top_names(path)
    assert not names & FORBIDDEN
    if "reference" in path.relative_to(ROOT).parts:
        assert "meters_lv2_torch" not in names
    if path.name != "system.py" and "tests" not in path.relative_to(ROOT).parts:
        assert "meters_lv2_torch" not in names  # the program enters through system.py


def test_a_run_loads_none(tmp_path):
    code = (
        "import sys; from portbench import harness\n"
        "c = harness.load_cell('r128_batch', {'batch': 4, 'block': 4800, 'pool_blocks': 2,"
        " 'programme_blocks': 2})\n"
        "harness.run_cell(c, 5, 0.1, False, device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n" % FORBIDDEN
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ prints no result."""
    import shutil

    shutil.copytree(ROOT, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "r128_batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "meters_lv2_torch" in out.stderr
