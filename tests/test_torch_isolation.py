"""The port stands alone: no module of paddle_tpu_torch/, and not
chip_smoke.py, imports jax or the JAX package (paddle_tpu, or its
``paddle`` alias), at any depth of the code."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "paddle")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [name for name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    assert len(FILES) > 15
    assert (ROOT / "chip_smoke.py").exists()
    for module in ("ops/detection_ops.py", "vision/detection_models.py",
                   "ops/moe_ops.py", "distributed/moe.py", "tensor_api.py",
                   "ops/linalg_ops.py", "ops/parity_ops.py",
                   "ops/long_tail_ops.py", "dygraph/engine.py",
                   "dygraph/compat1x.py", "testing/op_cases.py"):
        assert ROOT / "paddle_tpu_torch" / module in FILES
