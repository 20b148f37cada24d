"""Nothing under portbench/ imports JAX or the JAX package, compared by the
whole top-level name; the reference and the yardstick import nothing of the
port either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vision_compression_project_tpu"}
PORT = "vision_compression_project_tpu_torch"
PLAIN = ("reference", "yardstick")
PLAIN_FILES = ("weights.py", "traffic.py")


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    found = imported_tops(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", [p for p in SOURCES if p.relative_to(HERE).parts[0] in PLAIN
                                  or p.name in PLAIN_FILES], ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_tops(path)


def test_whole_name_comparison():
    from portbench.harness import FORBIDDEN as HARNESS_FORBIDDEN

    assert "vision_compression_project_tpu" in HARNESS_FORBIDDEN
    assert not (imported_tops(HERE / "harness.py") & FORBIDDEN)
    # The port's name begins with the JAX package's: only the whole top-level name counts.
    assert PORT.split(".", 1)[0] not in FORBIDDEN


def test_run_leaves_no_jax_loaded(tmp_path):
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import portbench.harness as h, portbench.drivers.train, "
            "portbench.drivers.extract; h.vlm_config({'vision': {}, 'decoder': {}}); "
            "print(h.forbidden_modules())" % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
