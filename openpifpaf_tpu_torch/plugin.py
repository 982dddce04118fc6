"""Plugin discovery and registration.

Port of ``openpifpaf_tpu/plugin.py``.  Reference parity:
``src/openpifpaf/plugin.py:~20``: the built-in plugins register their
data modules, then every importable top-level module whose name starts
with ``PREFIX`` is imported and its ``register()`` called.  The prefix
differs from the JAX package's (``openpifpaf_tpu_``), which imports every
module under its own prefix as it is imported itself: a plugin of the port
is never imported by the JAX package, and the port (whose own name starts
with ``openpifpaf_tpu_``) keeps no ``register`` at its top level.
"""

from __future__ import annotations

import importlib
import logging
import pkgutil

from . import plugins

LOG = logging.getLogger(__name__)

PREFIX = 'openpifpaf_torch_'
REGISTERED = {}  # name -> module


def register() -> None:
    """Register the built-in plugins and discover the external ones
    (idempotent)."""
    if plugins.__name__ not in REGISTERED:
        plugins.register()
        REGISTERED[plugins.__name__] = plugins

    for _, name, _ in pkgutil.iter_modules():
        if not name.startswith(PREFIX) or name in REGISTERED:
            continue
        try:
            module = importlib.import_module(name)
        except ImportError as e:
            LOG.warning('could not import plugin %s: %s', name, e)
            continue
        if hasattr(module, 'register'):
            module.register()
            REGISTERED[name] = module
