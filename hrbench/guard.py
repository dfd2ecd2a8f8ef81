"""What no run may load, and what the reference may not import.

The program under test is the PyTorch port, hopperrender_tpu_torch. The JAX
package beside it, hopperrender_tpu, and JAX itself are neither measured
nor run: after the window, `loaded_forbidden` names any of them that the
process holds, compared by whole top-level module names (so
hopperrender_tpu_torch is not hopperrender_tpu). The reference that decides
`correct` must not lean on the program either: `reference_imports` names
any import of the port, the JAX package or JAX in hrbench/reference/'s
sources and in the rest of the yardstick (the work arithmetic, the input
generator, the check).
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN_LOADED = ("jax", "jaxlib", "flax", "hopperrender_tpu")
FORBIDDEN_IN_REFERENCE = FORBIDDEN_LOADED + ("hopperrender_tpu_torch",)
HERE = Path(__file__).resolve().parent
REFERENCE_SOURCES = (*sorted((HERE / "reference").glob("*.py")), HERE / "work.py",
                     HERE / "inputs.py", HERE / "check.py")


def loaded_forbidden(modules=None) -> list[str]:
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_LOADED))


def reference_imports(paths=REFERENCE_SOURCES) -> list[str]:
    """'<file>: <module>' for each import of a forbidden top-level name."""
    found = []
    for path in paths:
        for node in ast.walk(ast.parse(Path(path).read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            found += [f"{Path(path).name}: {n}" for n in names
                      if n.split(".")[0] in FORBIDDEN_IN_REFERENCE]
    return found
