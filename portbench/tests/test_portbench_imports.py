"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole, so bwamem_tpu_torch is not bwamem_tpu), and the
reference side imports nothing of the port."""
import ast

from pbtest_helpers import PB

FORBIDDEN = {"jax", "jaxlib", "flax", "bwamem_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not FORBIDDEN & set(_imports(f)), f


def test_reference_side_imports_no_port():
    # only the child (and the tests' children built on it) runs the port
    for f in sorted((PB / "pbcore").glob("*.py")) + [PB / "run.py",
                                                      PB / "control.py"]:
        assert "bwamem_tpu_torch" not in set(_imports(f)), f
    assert "bwamem_tpu_torch" in set(_imports(PB / "child.py"))
