"""No module of the benchmark imports JAX, Flax or the JAX package, and the
reference imports nothing of the port; names compared whole."""
import ast

from conftest import BENCH
from harness import core

PORT = "easy_vitpose_tpu_torch"


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = set(imported_tops(f)) & set(core.FORBIDDEN)
        assert not bad, f"{f} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert PORT not in set(imported_tops(f)), f


def test_forbidden_modules_compares_whole_names():
    assert core.forbidden_modules(["easy_vitpose_tpu_torch", "easy_vitpose_tpu_torch.models",
                                   "jaxtyping", "numpy"]) == []
    assert core.forbidden_modules(["jax.numpy", "easy_vitpose_tpu.models", "flax"]) == [
        "easy_vitpose_tpu", "flax", "jax"]
