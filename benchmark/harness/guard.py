"""The check that the run loaded none of the JAX side: the JAX package,
JAX itself or Flax.  Names are compared by their top-level part, whole,
so the port (xsqueezeit_tpu_torch) is not taken for the JAX package
(xsqueezeit_tpu)."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "xsqueezeit_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)
