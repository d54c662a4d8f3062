"""The plain float32 references the cells' outputs are held to.  Imports
neither JAX nor anything of the program.

A configuration names its reference by the harness key ``"reference"`` in
its file (``model``, the shared forward, where it names none): the module
``reference/<name>.py``.  A reference module gives

* ``logits(weights, arch, tokens, rows, *, precision)``, what a serving
  cell's check runs;
* ``FORWARD``, a :class:`~portbench.reference.model.Forward` of its pieces
  (embedding, one layer, final norm and head), which ``train.steps`` runs;
  a module without it has no training path, and a training cell over its
  configuration is refused;
* ``neutral_keys(head_dim)``, the published ``config.json`` keys it runs
  beyond the core fields of :class:`~portbench.arch.Arch`, each at the
  value under which it is the shared forward (``arch.forward_keys``'s
  value, where that table has the key).  ``arch.load`` carries these keys
  on the ``Arch``.

Only the reference a configuration names is imported.
"""
from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent


def module(name: str, root: Optional[Path] = None) -> ModuleType:
    """The reference module ``reference/<name>.py``: this package's own; else
    the one the benchmark under ``root`` adds, loaded from its file (as
    ``cells`` loads a metric's reader); else one added so before."""
    qual = f"{__name__}.{name}"
    if name.isidentifier() and name != "train":
        if (HERE / f"{name}.py").is_file():
            return importlib.import_module(qual)
        added = root and Path(root).resolve() / "portbench" / "reference" / f"{name}.py"
        if added and added.is_file():
            mod = sys.modules.get(qual)
            if mod is None or Path(mod.__file__).resolve() != added:
                spec = importlib.util.spec_from_file_location(qual, added)
                mod = importlib.util.module_from_spec(spec)
                sys.modules[qual] = mod
                try:
                    spec.loader.exec_module(mod)
                except BaseException:
                    del sys.modules[qual]
                    raise
            return mod
        if root is None and qual in sys.modules:
            return sys.modules[qual]
    raise ValueError(f"{name!r} names no reference module: no reference/{name}.py")


def neutral_keys(name: str, head_dim: int, root: Optional[Path] = None) -> Dict[str, object]:
    """The keys that the reference ``name`` runs, at their neutral values."""
    declare = getattr(module(name, root), "neutral_keys", None)
    return dict(declare(head_dim)) if declare else {}


def forward(name: str, root: Optional[Path] = None):
    """The pieces ``train.steps`` runs for the reference ``name``; raises
    where the module gives no training path (no ``FORWARD``)."""
    pieces = getattr(module(name, root), "FORWARD", None)
    if pieces is None:
        raise ValueError(f"the reference {name!r} gives no training path: "
                         f"reference/{name}.py has no FORWARD")
    return pieces
