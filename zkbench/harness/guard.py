"""What the benchmark may not load.

The measured program is the PyTorch and CUDA package; JAX and the JAX
package beside it are never run.  Names are compared whole, by the
part before the first dot: ``nexus_zkvm_tpu_torch`` is not
``nexus_zkvm_tpu``.  The plain reference under ``reference/`` also
imports nothing of the measured package.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

__all__ = ["FORBIDDEN", "PROGRAM", "loaded_forbidden", "source_imports",
           "reference_faults"]

FORBIDDEN = ("jax", "jaxlib", "flax", "nexus_zkvm_tpu")
PROGRAM = "nexus_zkvm_tpu_torch"


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among loaded modules."""
    names = {m.split(".", 1)[0] for m in (modules if modules is not None
                                          else list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


def source_imports(path: Path) -> set:
    """Top-level names of every absolute import in a Python file."""
    tree = ast.parse(Path(path).read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add((node.module or "").split(".", 1)[0])
    return out


def reference_faults(root: Path) -> list:
    """(file, name) of each import of JAX, the JAX package or the
    measured package anywhere under ``root``."""
    bad = set(FORBIDDEN) | {PROGRAM}
    return [(str(p), name) for p in sorted(Path(root).rglob("*.py"))
            for name in sorted(source_imports(p) & bad)]
