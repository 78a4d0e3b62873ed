"""The import guard: no JAX, and nothing of the JAX package, in a
process that measures the port. Names are compared whole, by the part
before the first dot, so ``distkeras_torch`` is not
``distkeras_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "distkeras_tpu"})

# set in the environment of every process the benchmark starts, so that
# libraries which would load JAX by themselves do not
ENV = {"USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}


def forbidden(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``modules``, sorted."""
    return sorted({m.split(".", 1)[0] for m in modules}
                  & FORBIDDEN)


def loaded() -> List[str]:
    """The forbidden top-level names this process has loaded."""
    return forbidden(list(sys.modules))
