"""fxtpu — an FX correlator framework in JAX.

Brand-new JAX/XLA implementation with the capabilities of
evanmayer/effex (see SURVEY.md for the structural map of the reference and
the file:line parity citations throughout this package).
"""

import os as _os
import pathlib as _pathlib

#: Persistent XLA compilation cache used when ``JAX_COMPILATION_CACHE_DIR``
#: is unset: one fixed directory inside the checkout (git-ignored).  The
#: path is part of the cache key, so it must not move between runs.  Where
#: the variable is set, JAX reads it itself and nothing is set here.
CACHE_DIR = _pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"

if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))

from fxtpu.config import CorrelatorConfig, STATES, MODES

__version__ = "0.1.0"

__all__ = ["CorrelatorConfig", "STATES", "MODES", "__version__"]
