"""Where entry-point scripts keep JAX's persistent compilation cache.

The cache key includes the directory, so the directory must not move from
run to run: it is either ``JAX_COMPILATION_CACHE_DIR`` when that is set, or
one fixed path inside the checkout (``<repo>/.jax_cache``, listed in
``.gitignore``). Entry points call :func:`enable_compile_cache` before their
first compile; the package itself and the tests never do.
"""

from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(REPO, ".jax_cache")


def compile_cache_dir() -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` or the fixed
    in-checkout default."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`.

    When the environment variable is set, JAX has already read it at import
    and nothing is set here. Returns the directory in use.
    """
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
