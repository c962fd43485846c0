"""
The package's former import name, kept as an alias of `bild_jax`.

``import`` of this name or of any submodule under it returns the `bild_jax`
module object itself (one copy of every module and of its state), and
``python -m`` of this name runs the `bild_jax` command line.
"""
import importlib
import importlib.abc
import importlib.util
import sys

import bild_jax
from bild_jax import *  # noqa: F401,F403

_TARGET = "bild_jax"


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<alias>.<sub>`` to the already-importable
    ``bild_jax.<sub>``."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(__name__ + ".") and name != __name__ + ".__main__":
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_TARGET + spec.name[len(__name__):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias spec on the shared module
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())
