"""The run's process must not have loaded JAX or the JAX package.

Modules are compared by their top-level name, the part before the first
dot, taken whole: `esvio_tpu_torch` (the port) begins with `esvio_tpu`
(the JAX package) and is not it.  Besides JAX's own packages, the JAX
package's benchmark script and the repository's `tools` and `tests`
import JAX, so none of them may be loaded either.
"""
from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "esvio_tpu", "bench", "tools",
                       "tests"})


def forbidden_loaded(modules) -> list:
    """The sorted top-level names among `modules` (names of sys.modules)
    that are forbidden."""
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN)
