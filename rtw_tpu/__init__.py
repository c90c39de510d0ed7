"""Former import name of the `rtw` package.

Kept so that existing imports and `python -m <this package>.cli` still
work.  Every module under this name is the `rtw` module of the same path
(the same object, not a copy); new code imports `rtw`.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import rtw


def _real_name(name):
    return "rtw" + name[len(__name__):]


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolve `<this package>.x.y` to the module `rtw.x.y`."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, name, path=None, target=None):
        if name.startswith(__name__ + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_real_name(spec.name))
        self._specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias spec on the real module;
        # give it back its own
        module.__spec__ = self._specs.pop(module.__spec__.name)

    def get_code(self, name):
        """The real module's code, for `python -m`."""
        real = importlib.util.find_spec(_real_name(name))
        return real.loader.get_code(real.name)


sys.meta_path.insert(0, _Alias())
sys.modules[__name__] = rtw
