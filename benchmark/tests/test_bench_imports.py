"""No run imports JAX or the JAX package, and the reference imports
nothing of the program; top-level module names are compared whole, since
``pyvisim_tpu_torch`` begins with ``pyvisim_tpu``."""
import ast
import pathlib
import subprocess
import sys

from benchmark import run

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def imported_tops(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("pyvisim_tpu_torch.index", "jaxtyping", "flax_like", "pyvisim_tpu_torch"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pyvisim_tpu.ops", type(sys)("pyvisim_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    assert run.forbidden_modules() == ["jax", "pyvisim_tpu"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported_tops(path) & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "dataclasses", "math", "typing", "numpy", "torch"}
    for path in (BENCH / "reference").glob("*.py"):
        assert imported_tops(path) <= allowed, path


DRY_RUN = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from benchmark import run
from benchmark.tests.conftest import GALLERY, QUERY, tiny_vgg
for mix in (GALLERY, QUERY):
    cell = run.Cell({"name": "t", "config": "x", "traffic": "y", "chips": 1}, 5, "cpu",
                    trace=True, cfg=tiny_vgg(), mix=mix)
    cell.warm_up()
    loop = cell.window(0.3, True)
    cell.free()
    cell.check_numbers(loop)
print(",".join(run.forbidden_modules()) or "none")
"""

REFERENCE_ONLY = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from benchmark.reference import index, quant, rootsift, sift, vgg16_int8, vlad
from benchmark.tests.conftest import tiny_vgg
cfg = tiny_vgg()
w = {f"features.{i}.weight": torch.zeros(1) for i in ()}
d = torch.randn(2, 5, 3); c = torch.randn(4, 3)
enc, labels = vlad.encode(d, torch.ones(2, 5), c)
index.scores(enc, torch.randn(6, enc.shape[1]))
print(sorted({m.split(".")[0] for m in sys.modules} & {"pyvisim_tpu_torch", "pyvisim_tpu", "jax"}))
"""


def test_a_dry_run_holds_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", DRY_RUN, str(ROOT)], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_the_reference_runs_without_loading_the_program():
    out = subprocess.run([sys.executable, "-c", REFERENCE_ONLY, str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
