"""Python files of the benchmark found by name: a metric's reader
(``metrics/<name>.py``), an encoder kind (``encoders/<kind>.py``), a query
kind (``queries/<kind>.py``).

A cell names its configuration and traffic; their ``encoder.kind`` and
``queries.kind`` pick the file. A later cell brings a new kind as one new
file in the directory, and no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path


def load(directory: Path, name: str):
    """The module ``<directory>/<name>.py``; a name with no file there is
    refused, naming the directory and the names it has."""
    directory = Path(directory)
    path = directory / f"{name}.py"
    if not path.is_file():
        found = sorted(p.stem for p in directory.glob("*.py"))
        raise ValueError(f"unknown kind {name!r}: {directory} has no {path.name}; "
                         f"the kinds found there: {found}")
    mod_name = f"bench_{directory.name}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
