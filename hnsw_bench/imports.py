"""What the benchmark may import: no module whose top-level name is `jax`,
`jaxlib`, `flax` or the JAX package `ocaml_hnsw_tpu`, anywhere under
`hnsw_bench/`; and nothing of the port in the reference's files.  Names are
compared whole, by the part before the first dot: the port's name,
`ocaml_hnsw_tpu_torch`, begins with the JAX package's."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ocaml_hnsw_tpu"})
PORT = "ocaml_hnsw_tpu_torch"
#: the plain reference and what decides `correct`: they import nothing of
#: the port
REFERENCE_FILES = ("reference.py", "judge.py", "data.py", "roofline.py",
                   "stats.py")


def imported(path: Path) -> set[str]:
    """Top-level names of every module `path` imports (any depth in the
    file, `import_module("...")` calls with a literal name included)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            out.add(node.args[0].value.split(".")[0])
    return out


def violations(root: Path) -> list[str]:
    """Each forbidden import under `root` (the `hnsw_bench` folder), as
    "file: module"."""
    bad = []
    for path in sorted(root.rglob("*.py")):
        names = imported(path)
        for name in sorted(names & FORBIDDEN):
            bad.append(f"{path.relative_to(root)}: {name}")
        if path.parent == root and path.name in REFERENCE_FILES \
                and PORT in names:
            bad.append(f"{path.relative_to(root)}: {PORT}")
    return bad


def loaded_forbidden() -> list[str]:
    """Forbidden top-level modules this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
