"""What the benchmark's process may not hold: JAX and the JAX package.

Names are compared by their top-level part (before the first dot), whole:
``md_rdm_tpu_torch`` is not ``md_rdm_tpu``.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "md_rdm_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_in(names: Iterable[str], banned=FORBIDDEN) -> List[str]:
    return sorted({top_level(n) for n in names} & set(banned))


def loaded_forbidden() -> List[str]:
    """Forbidden top-level modules in ``sys.modules`` now."""
    return forbidden_in(list(sys.modules))
