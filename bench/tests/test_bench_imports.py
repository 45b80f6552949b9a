"""Nothing the benchmark loads on the card is JAX, its libraries or the
JAX package (top-level names compared whole: the program's own name
begins with the JAX package's), and the reference imports nothing of the
program."""
import ast
import subprocess
import sys

import pytest
import smoke

from bench import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py")
               if "tests" not in p.relative_to(harness.BENCH).parts)


def imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(harness.BENCH).as_posix())
def test_no_jax_imports(path):
    for name in imported(path):
        assert name.split(".")[0] not in harness.BANNED, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").rglob("*.py"):
        for name in imported(path):
            assert name.split(".")[0] in ("torch", "math", "__future__"), \
                (path, name)


def test_loaded_modules_after_a_cell_has_no_jax():
    """Everything a run imports, loaded in a fresh process (a smoke cell
    run through on the CPU), leaves no JAX module behind."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(smoke.CHECKOUT / 'bench' / 'tests')!r})\n"
        "import smoke\n"
        "from bench import harness, run, energy, work, weights, traffic\n"
        "for w in ('phi3-14b.chain', 'phi3-14b.serve'):\n"
        "    smoke.run_cell(smoke.smoke_cell(w, seconds=1.0))\n"
        "for m in harness.load_spec()['per_layer']:\n"
        "    harness.load_module('metrics', m['name'])\n"
        "print(harness.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={
                             "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro.fake" in harness.banned_modules()
