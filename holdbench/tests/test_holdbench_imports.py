"""No module a run loads imports jax, jaxlib, flax or hold_tpu (by the whole
top-level name: hold_tpu_torch is not hold_tpu), and the reference imports
nothing of hold_tpu_torch: an AST walk of every file a toy run of each
entry kind has loaded, of every metric reader (loaded from its file, so
not in sys.modules), and of every file of holdbench/reference/.  A run
that has one of them loaded when it would print exits 3."""

import ast
import sys
from pathlib import Path

from holdbench.tests import toy

FORBIDDEN = {"jax", "jaxlib", "flax", "hold_tpu"}
REPO = toy.SRC.parent


def _top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_loaded_modules_import_no_jax(toy_root, run_cell):
    for cell in ("toy_train", "toy_render"):
        rc, res = run_cell(cell)
        assert rc == 0  # 3 when sys.modules holds any of them after the window
    files = [Path(m.__file__) for m in list(sys.modules.values())
             if getattr(m, "__file__", None) and Path(m.__file__).is_absolute()
             and Path(m.__file__).suffix == ".py" and REPO in Path(m.__file__).resolve().parents]
    loaded = {p.resolve().relative_to(REPO).parts[0] for p in files}
    assert {"holdbench", "hold_tpu_torch"} <= loaded
    for p in files + sorted((toy.SRC / "metrics").glob("*.py")):
        if "tests" in p.parts:
            continue
        assert not (_top_imports(p) & FORBIDDEN), p


def test_a_reader_that_loads_jax_refuses_the_result(toy_root, run_cell):
    (toy_root / "metrics" / "loads_jax.train.py").write_text(
        'import sys\nimport types\n\nKINDS = ("train",)\nUNIT = "steps"\nLAYER = "test"\n'
        'MOVES = "train_rays_per_s"\n\n\ndef read(t):\n'
        '    sys.modules["jax"] = types.ModuleType("jax")\n    return 1.0\n')
    assert "jax" not in sys.modules
    try:
        rc, res = run_cell("toy_train", trace=1)
    finally:
        sys.modules.pop("jax", None)
    assert rc == 3 and res is None
