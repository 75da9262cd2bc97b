"""The import checks: nothing a run loads is JAX or the JAX package, and
the reference loads nothing of the program.  Names are compared by their
top-level part (before the first dot) whole, so ``tpu_plume_torch`` is not
``tpu_plume``."""

from __future__ import annotations

import ast
import glob
import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "tpu_plume"})
# What the reference may not import besides the forbidden names.
PROGRAM = frozenset({"tpu_plume_torch"})
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "reference")


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The loaded modules (``sys.modules`` by default) whose top-level name
    is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)


def reference_imports() -> dict:
    """{file: [imported module]} of every file of ``reference/``, from its
    source (absolute imports only; a relative one is reported as such)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(REFERENCE, "*.py"))):
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        found = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                found.append("." if node.level else node.module)
        out[os.path.basename(path)] = found
    return out


def reference_faults() -> list:
    """"file: module" of each import of ``reference/`` that is forbidden,
    of the program, or relative."""
    bad = FORBIDDEN | PROGRAM
    return [f"{f}: {m}" for f, mods in reference_imports().items()
            for m in mods if m == "." or top(m) in bad]
