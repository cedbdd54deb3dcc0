"""What the benchmark must not load, compared by whole top-level names.

The port's package name begins with the JAX package's
(``privacy_preserving_sfm_torch`` against ``privacy_preserving_sfm_tpu``),
so a prefix match would confuse them: each module name is cut at its first
dot and compared whole.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "privacy_preserving_sfm_tpu")
PROGRAM = "privacy_preserving_sfm_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(names: Iterable[str], modules: Iterable[str] = None) -> List[str]:
    """The modules of ``modules`` (default ``sys.modules``) whose top-level
    name is one of ``names``."""
    names = set(names)
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if top_level(m) in names)
