"""Lazy package exports (PEP 562).

Each package `__init__` of the port lists the names it exports, as the JAX
package's `__init__` files do, with the module that defines each. A name's
module is imported on its first access, so importing a package, as a
spawned loader worker or a gloo rank does when it re-imports
`posegen_tpu_torch.data.h5dataset`, costs no more than its own modules,
and no package import can close a cycle.
"""

from __future__ import annotations

import importlib
import sys
from typing import Dict


def exports(package: str, table: Dict[str, str]):
    """-> (`__getattr__`, `__dir__`) for `package`, where `table` maps each
    exported name to the module that defines it (a submodule to itself)."""

    def __getattr__(name: str):
        where = table.get(name)
        if where is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(where)
        value = module if where == f"{package}.{name}" else getattr(module, name)
        setattr(sys.modules[package], name, value)
        return value

    def __dir__():
        return sorted(set(vars(sys.modules[package])) | set(table))

    return __getattr__, __dir__


def table(*groups) -> Dict[str, str]:
    """{name: module} from (module, names) pairs; a name given as the
    module's own last component exports the submodule."""
    return {name: module for module, names in groups for name in names}
