"""The check that the process under measurement never loaded JAX or the
JAX package: module names are compared by their whole top-level name (the
part before the first dot), since the port's own name begins with the JAX
package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "defl_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
