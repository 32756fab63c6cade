"""The `bebopc` equivalent: compile `.bop` text to a resolved, decorated Schema.

Pipeline (§6.1): lex -> parse -> import resolution (topological, cycle-checked)
-> type resolution -> decorator validate/export execution -> Schema.

Imports are resolved through a loader.  The default loader reads from the
filesystem relative to the importing file plus any `include_dirs`; the
`builtin:` namespace ships `bebop/decorators.bop` (a small standard decorator
library) the way the paper's compiler does.

Copied unchanged from the JAX package's ``core/compiler.py``.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

from . import types as T
from .decorators import apply_decorators
from .parser import ParsedFile, Parser, resolve
from .schema import Schema

BUILTIN_SOURCES: Dict[str, str] = {
    "bebop/decorators.bop": """
// Standard decorator library.
#decorator(deprecated) {
  targets = ALL
  param reason?: string
  export [[ return { reason = reason or "" } ]]
}
#decorator(debug) {
  targets = ALL
}
#decorator(indexed) {
  targets = FIELD
  param unique?: bool
  export [[
    local t, f = target.parent, target.name
    return {
      index_name = t .. "_" .. f .. "_idx",
      table_name = t, column_name = f,
      is_unique = unique or false
    }
  ]]
}
#decorator(validate_range) {
  targets = FIELD
  param min!: float64
  param max!: float64
  validate [[
    if min > max then error("min must not exceed max") end
  ]]
  export [[ return { min = min, max = max } ]]
}
""",
}


class CompileError(T.SchemaError):
    pass


Loader = Callable[[str, Optional[str]], str]


def default_loader(include_dirs: Optional[List[str]] = None) -> Loader:
    dirs = list(include_dirs or [])

    def load(path: str, importer: Optional[str]) -> str:
        if path in BUILTIN_SOURCES:
            return BUILTIN_SOURCES[path]
        candidates = []
        if importer and importer not in ("<schema>",):
            candidates.append(os.path.join(os.path.dirname(importer), path))
        candidates.append(path)
        for d in dirs:
            candidates.append(os.path.join(d, path))
        for c in candidates:
            if os.path.isfile(c):
                with open(c, "rb") as f:
                    return f.read().decode("utf-8")
        raise CompileError(f"cannot resolve import {path!r}")

    return load


def compile_source(src: str, *, filename: str = "<schema>",
                   loader: Optional[Loader] = None) -> Schema:
    """Compile one source string (plus its import closure) into a Schema."""
    loader = loader or default_loader()
    loaded: Dict[str, ParsedFile] = {}
    loading: List[str] = []

    def load_file(path: str, text: str) -> ParsedFile:
        if path in loaded:
            return loaded[path]
        if path in loading:
            raise CompileError(
                f"import cycle: {' -> '.join(loading + [path])}")
        loading.append(path)
        pf = Parser(text, filename=path).parse()
        for imp in pf.imports:
            load_file(imp, loader(imp, path))
        loading.pop()
        loaded[path] = pf
        return pf

    root = load_file(filename, src)

    # merge: imports first (definition order preserved), root last
    merged = Schema(package=root.package, edition=root.edition)
    merged.imports = root.imports
    for path, pf in loaded.items():
        for name in pf.schema.order:
            if name in merged.definitions:
                if path == filename:
                    raise CompileError(f"duplicate definition {name}")
                continue  # diamond imports are fine
            merged.definitions[name] = pf.schema.definitions[name]
            merged.order.append(name)
        for dname, d in pf.schema.decorator_defs.items():
            if dname not in merged.decorator_defs:
                merged.decorator_defs[dname] = d

    resolve(merged)
    apply_decorators(merged)
    return merged


def compile_file(path: str, *, include_dirs: Optional[List[str]] = None
                 ) -> Schema:
    with open(path, "rb") as f:
        src = f.read().decode("utf-8")
    return compile_source(src, filename=path,
                          loader=default_loader(include_dirs))
