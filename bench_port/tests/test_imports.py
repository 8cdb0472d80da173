"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package
fhe_si_tpu (top-level names compared whole: fhe_si_tpu_torch is the
program), and the reference imports nothing but numpy and the standard
library."""
import ast
import subprocess
import sys

from bench_port import run
from helpers import REPO

BENCH = REPO / "bench_port"


def _imports(path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_in_sources():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(run.FORBIDDEN), path


def test_reference_is_plain():
    for path in (BENCH / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "numpy"}, path


def test_whole_names():
    saved = dict(sys.modules)
    try:
        sys.modules["fhe_si_tpu_torch_fake.x"] = sys
        assert run.forbidden_modules() == []
        sys.modules["fhe_si_tpu.x"] = sys
        assert run.forbidden_modules() == ["fhe_si_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_run_loads_no_jax():
    """A whole small run in a fresh process, then its modules."""
    code = (
        "import sys, time; sys.path.insert(0, {root!r}); "
        "sys.path.insert(0, {tests!r}); "
        "import tempfile, pathlib; from helpers import *; "
        "from bench_port import cell, run; "
        "t = pathlib.Path(tempfile.mkdtemp()); root, data = bench_root(t); "
        "add_config(data, 'ring256', SMALL); add_traffic(data, 'b4', TINY_MIX); "
        "add_cell(root, 'ring256.b4', 'ring256', 'b4'); "
        "c = cell.load('ring256.b4', root=root, data=data); "
        "r = run.run_cell(c, 9, 0.2, True, 'cpu', time.perf_counter()); "
        "assert r['check']['mismatched_limbs'] == 0; "
        "print(run.forbidden_modules(), 'fhe_si_tpu_torch' in sys.modules)"
    ).format(root=str(REPO), tests=str(BENCH / "tests"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"
