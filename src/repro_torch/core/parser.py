"""Parser for the `.bop` schema language (§5).

Single pass over tokens into unresolved definitions (type references are
`TypeRef` placeholders), then a resolution pass replaces references and
finalizes `types.py` nodes.  The compiler (compiler.py) drives imports,
decorator execution and constant evaluation on top of this.

Copied unchanged from the JAX package's ``core/parser.py``; its lazy
types subclass this package's ``types`` nodes, so :func:`resolve` gives
back the port's own ``Struct``, ``Message`` and ``Union`` objects.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Tuple

from . import types as T
from .lexer import Token, lex
from .schema import (ConstDef, DecoratorDef, DecoratorParam, MethodDef,
                     Schema, ServiceDef)


class ParseError(T.SchemaError):
    pass


class TypeRef(T.Type):
    """Unresolved reference to a named type."""

    def __init__(self, name: str):
        self.name = name

    def static_size(self):
        return None

    def type_name(self):
        return self.name


_PRIM_NAMES = set(T._PRIM_SPECS) | set(T.ALIASES) | {"string"}


@dataclasses.dataclass
class ParsedFile:
    edition: str
    package: str
    imports: List[str]
    schema: Schema


class Parser:
    def __init__(self, src: str, *, filename: str = "<schema>"):
        self.toks = lex(src, filename=filename)
        self.i = 0
        self.filename = filename

    # -- token plumbing ------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def err(self, msg: str, tok: Optional[Token] = None):
        tok = tok or self.peek()
        raise ParseError(f"{self.filename}:{tok.line}:{tok.col}: {msg}")

    def expect_punct(self, p: str) -> Token:
        t = self.next()
        if t.kind != "PUNCT" or t.value != p:
            self.err(f"expected {p!r}, got {t.value!r}", t)
        return t

    def expect_ident(self, what: str = "identifier") -> str:
        t = self.next()
        if t.kind != "IDENT":
            self.err(f"expected {what}, got {t.value!r}", t)
        return t.value

    def at_punct(self, p: str) -> bool:
        t = self.peek()
        return t.kind == "PUNCT" and t.value == p

    def at_ident(self, word: Optional[str] = None) -> bool:
        t = self.peek()
        return t.kind == "IDENT" and (word is None or t.value == word)

    def eat_ident(self, word: str) -> bool:
        if self.at_ident(word):
            self.next()
            return True
        return False

    def collect_doc(self) -> str:
        lines = []
        while self.peek().kind == "DOC":
            lines.append(self.next().value)
        return "\n".join(lines)

    # -- entry ----------------------------------------------------------
    def parse(self) -> ParsedFile:
        edition, package = "2026", ""
        # header
        while True:
            if self.at_ident("edition"):
                self.next()
                self.expect_punct("=")
                t = self.next()
                if t.kind != "STRING":
                    self.err("edition expects a string", t)
                edition = t.value
            elif self.at_ident("package"):
                self.next()
                package = self._dotted_name()
            else:
                break
        imports = []
        while self.at_ident("import"):
            self.next()
            t = self.next()
            if t.kind != "STRING":
                self.err("import expects a string path", t)
            imports.append(t.value)
        schema = Schema(package=package, edition=edition)
        schema.imports = imports
        while self.peek().kind != "EOF":
            self._definition(schema, default_visibility="export")
        return ParsedFile(edition, package, imports, schema)

    def _dotted_name(self) -> str:
        parts = [self.expect_ident()]
        while self.at_punct("."):
            self.next()
            parts.append(self.expect_ident())
        return ".".join(parts)

    # -- definitions ------------------------------------------------------
    def _definition(self, schema: Schema, *, default_visibility: str,
                    prefix: str = "") -> None:
        doc = self.collect_doc()
        decorators = self._decorator_usages()
        doc = doc or self.collect_doc()
        visibility = default_visibility
        if self.eat_ident("local"):
            visibility = "local"
        elif self.eat_ident("export"):
            visibility = "export"
        if self.at_punct("#"):
            self._decorator_def(schema, doc)
            return
        mutable = self.eat_ident("mut")
        t = self.peek()
        if t.kind != "IDENT":
            self.err(f"expected definition, got {t.value!r}", t)
        kw = t.value
        if kw == "enum":
            self._enum(schema, doc, visibility, decorators, prefix)
        elif kw == "struct":
            self._struct(schema, doc, visibility, mutable, decorators, prefix)
        elif kw == "message":
            self._message(schema, doc, visibility, decorators, prefix)
        elif kw == "union":
            self._union(schema, doc, visibility, decorators, prefix)
        elif kw == "service":
            self._service(schema, doc, visibility, decorators)
        elif kw == "const":
            self._const(schema, doc, visibility)
        else:
            self.err(f"unknown definition keyword {kw!r}", t)

    def _decorator_usages(self) -> List[T.DecoratorUsage]:
        out = []
        while self.at_punct("@"):
            self.next()
            name = self.expect_ident("decorator name")
            args: Dict[str, object] = {}
            if self.at_punct("("):
                self.next()
                while not self.at_punct(")"):
                    key = self.expect_ident("argument name")
                    self.expect_punct("=")
                    args[key] = self._literal()
                    if self.at_punct(","):
                        self.next()
                self.expect_punct(")")
            out.append(T.DecoratorUsage(name, args))
        return out

    def _literal(self):
        t = self.next()
        if t.kind in ("NUMBER", "STRING", "BYTES", "BOOLLIT"):
            return t.value
        if t.kind == "PUNCT" and t.value == "[":
            items = []
            while not self.at_punct("]"):
                items.append(self._literal())
                if self.at_punct(","):
                    self.next()
            self.expect_punct("]")
            return items
        if t.kind == "IDENT":
            return t.value  # enum member reference etc.
        self.err(f"expected literal, got {t.value!r}", t)

    # -- types ------------------------------------------------------------
    def _type(self) -> T.Type:
        if self.at_ident("map"):
            self.next()
            self.expect_punct("[")
            key = self._type()
            self.expect_punct(",")
            val = self._type()
            self.expect_punct("]")
            base: T.Type = _map_lazy(key, val)
        else:
            name = self._dotted_name()
            if name in _PRIM_NAMES:
                base = T.STRING if name == "string" else T.Prim(name)
            else:
                base = TypeRef(name)
        # array suffixes
        while self.at_punct("["):
            self.next()
            if self.at_punct("]"):
                self.next()
                base = T.Array(base)
            else:
                t = self.next()
                if t.kind != "NUMBER" or not isinstance(t.value, int):
                    self.err("fixed array size must be an integer", t)
                self.expect_punct("]")
                base = _fixed_array_lazy(base, t.value)
        return base

    # -- enum ---------------------------------------------------------------
    def _enum(self, schema, doc, visibility, decorators, prefix):
        self.next()  # 'enum'
        name = prefix + self.expect_ident("enum name")
        base = T.UINT32
        if self.at_punct(":"):
            self.next()
            bn = self.expect_ident("base type")
            base = T.Prim(bn)
        self.expect_punct("{")
        members: Dict[str, int] = {}
        while not self.at_punct("}"):
            self.collect_doc()
            m = self.expect_ident("member name")
            self.expect_punct("=")
            t = self.next()
            if t.kind != "NUMBER" or not isinstance(t.value, int):
                self.err("enum value must be an integer", t)
            members[m] = t.value
            if self.at_punct(";") or self.at_punct(","):
                self.next()
        self.expect_punct("}")
        schema.add(T.Enum(name, members, base=base, doc=doc,
                          visibility=visibility, decorators=decorators))

    # -- struct / message ------------------------------------------------
    def _struct(self, schema, doc, visibility, mutable, decorators, prefix):
        self.next()  # 'struct'
        name = prefix + self.expect_ident("struct name")
        self.expect_punct("{")
        fields: List[T.Field] = []
        while not self.at_punct("}"):
            if self._maybe_nested(schema, name):
                continue
            fdoc = self.collect_doc()
            fdecs = self._decorator_usages()
            fdoc = fdoc or self.collect_doc()
            fname = self.expect_ident("field name")
            self.expect_punct(":")
            ftype = self._type()
            self.expect_punct(";")
            fields.append(T.Field(fname, ftype, doc=fdoc, decorators=fdecs))
        self.expect_punct("}")
        schema.add(_LazyStruct(name, fields, mutable=mutable, doc=doc,
                               visibility=visibility, decorators=decorators))

    def _message(self, schema, doc, visibility, decorators, prefix):
        self.next()  # 'message'
        name = prefix + self.expect_ident("message name")
        self.expect_punct("{")
        fields: List[T.Field] = []
        while not self.at_punct("}"):
            if self._maybe_nested(schema, name):
                continue
            fdoc = self.collect_doc()
            fdecs = self._decorator_usages()
            fdoc = fdoc or self.collect_doc()
            fname = self.expect_ident("field name")
            self.expect_punct("(")
            t = self.next()
            if t.kind != "NUMBER" or not isinstance(t.value, int):
                self.err("message tag must be an integer", t)
            self.expect_punct(")")
            self.expect_punct(":")
            ftype = self._type()
            self.expect_punct(";")
            fields.append(T.Field(fname, ftype, tag=t.value, doc=fdoc,
                                  decorators=fdecs))
        self.expect_punct("}")
        schema.add(_LazyMessage(name, fields, doc=doc, visibility=visibility,
                                decorators=decorators))

    def _maybe_nested(self, schema, parent: str) -> bool:
        """Nested definitions are local by default; `export` opts out (§5.12)."""
        save = self.i
        self.collect_doc()
        vis = "local"
        if self.eat_ident("export"):
            vis = "export"
        elif self.eat_ident("local"):
            vis = "local"
        self.eat_ident("mut")
        if self.at_ident("struct") or self.at_ident("message") \
                or self.at_ident("union") or self.at_ident("enum"):
            self.i = save
            self._definition(schema, default_visibility=vis,
                             prefix=parent + ".")
            return True
        self.i = save
        return False

    # -- union --------------------------------------------------------------
    def _union(self, schema, doc, visibility, decorators, prefix):
        self.next()  # 'union'
        name = prefix + self.expect_ident("union name")
        self.expect_punct("{")
        branches: List[T.Branch] = []
        idx = 0
        while not self.at_punct("}"):
            bdoc = self.collect_doc()
            bname = self.expect_ident("branch name")
            self.expect_punct("(")
            t = self.next()
            if t.kind != "NUMBER" or not isinstance(t.value, int):
                self.err("discriminator must be an integer", t)
            disc = t.value
            self.expect_punct(")")
            self.expect_punct(":")
            if self.at_punct("{"):
                # inline struct or message body
                btype = self._inline_body(f"{name}.{bname}", schema)
            else:
                btype = self._type()
            self.expect_punct(";")
            branches.append(T.Branch(bname, disc, btype, doc=bdoc))
            idx += 1
        self.expect_punct("}")
        schema.add(_LazyUnion(name, branches, doc=doc, visibility=visibility,
                              decorators=decorators))

    def _inline_body(self, name: str, schema) -> T.Type:
        self.expect_punct("{")
        fields: List[T.Field] = []
        tagged = None
        while not self.at_punct("}"):
            fdoc = self.collect_doc()
            fname = self.expect_ident("field name")
            tag = None
            if self.at_punct("("):
                self.next()
                t = self.next()
                tag = t.value
                self.expect_punct(")")
            if tagged is None:
                tagged = tag is not None
            elif tagged != (tag is not None):
                self.err("cannot mix tagged and untagged fields")
            self.expect_punct(":")
            ftype = self._type()
            self.expect_punct(";")
            fields.append(T.Field(fname, ftype, tag=tag, doc=fdoc))
        self.expect_punct("}")
        if tagged:
            inner: T.Type = _LazyMessage(name, fields, visibility="local")
        else:
            inner = _LazyStruct(name, fields, visibility="local")
        schema.add(inner)
        return inner

    # -- service --------------------------------------------------------
    def _service(self, schema, doc, visibility, decorators):
        self.next()  # 'service'
        name = self.expect_ident("service name")
        extends: List[str] = []
        if self.eat_ident("with"):
            extends.append(self._dotted_name())
            while self.at_punct(","):
                self.next()
                extends.append(self._dotted_name())
        self.expect_punct("{")
        methods: List[Tuple] = []
        while not self.at_punct("}"):
            mdoc = self.collect_doc()
            mdecs = self._decorator_usages()
            mdoc = mdoc or self.collect_doc()
            mname = self.expect_ident("method name")
            self.expect_punct("(")
            client_stream = self.eat_ident("stream")
            req = self._type()
            self.expect_punct(")")
            self.expect_punct(":")
            server_stream = self.eat_ident("stream")
            res = self._type()
            self.expect_punct(";")
            methods.append((mname, req, res, client_stream, server_stream,
                            mdoc, mdecs))
        self.expect_punct("}")
        schema.add(_LazyService(name, methods, extends, doc, visibility,
                                decorators))

    # -- const ------------------------------------------------------------
    def _const(self, schema, doc, visibility):
        self.next()  # 'const'
        ctype = self._type()
        name = self.expect_ident("constant name")
        self.expect_punct("=")
        raw = self._literal()
        self.expect_punct(";")
        schema.add(_LazyConst(name, ctype, raw, doc, visibility))

    # -- decorator definition --------------------------------------------
    def _decorator_def(self, schema: Schema, doc: str):
        self.expect_punct("#")
        kw = self.expect_ident()
        if kw != "decorator":
            self.err(f"expected 'decorator', got {kw!r}")
        self.expect_punct("(")
        name = self.expect_ident("decorator name")
        self.expect_punct(")")
        self.expect_punct("{")
        targets: List[str] = []
        params: List[DecoratorParam] = []
        validate_src = export_src = None
        while not self.at_punct("}"):
            key = self.expect_ident()
            if key == "targets":
                self.expect_punct("=")
                targets.append(self.expect_ident())
                while self.at_punct("|") if False else self.at_punct(","):
                    self.next()
                    targets.append(self.expect_ident())
            elif key == "param":
                pname = self.expect_ident("param name")
                required = False
                if self.at_punct("!"):
                    self.next()
                    required = True
                elif self.at_punct("?"):
                    self.next()
                self.expect_punct(":")
                ptype = self.expect_ident("param type")
                params.append(DecoratorParam(pname, ptype, required))
            elif key == "validate":
                t = self.next()
                if t.kind != "RAWBLOCK":
                    self.err("validate expects a [[ ]] block", t)
                validate_src = t.value
            elif key == "export":
                t = self.next()
                if t.kind != "RAWBLOCK":
                    self.err("export expects a [[ ]] block", t)
                export_src = t.value
            else:
                self.err(f"unknown decorator clause {key!r}")
            if self.at_punct(";"):
                self.next()
        self.expect_punct("}")
        schema.add_decorator(DecoratorDef(name, targets, params,
                                          validate_src, export_src, doc))


# --------------------------------------------------------------------------
# Lazy wrappers — carry unresolved TypeRefs until resolution
# --------------------------------------------------------------------------


class _LazyStruct(T.Struct):
    def __init__(self, name, fields, *, mutable=False, doc="",
                 visibility="export", decorators=None):
        # skip field-type validation until resolution
        self.name = name
        self.fields = list(fields)
        self.mutable = mutable
        self.doc = doc
        self.visibility = visibility
        self.decorators = decorators or []


class _LazyMessage(T.Message):
    def __init__(self, name, fields, *, doc="", visibility="export",
                 decorators=None):
        self.name = name
        self.fields = list(fields)
        self.doc = doc
        self.visibility = visibility
        self.decorators = decorators or []
        tags = set()
        for f in self.fields:
            if f.tag is None or not (1 <= f.tag <= T.MAX_TAG):
                raise ParseError(f"message {name}.{f.name}: bad tag {f.tag}")
            if f.tag in tags:
                raise ParseError(f"message {name}: duplicate tag {f.tag}")
            tags.add(f.tag)


class _LazyUnion(T.Union):
    def __init__(self, name, branches, *, doc="", visibility="export",
                 decorators=None):
        self.name = name
        self.branches = list(branches)
        self.doc = doc
        self.visibility = visibility
        self.decorators = decorators or []


@dataclasses.dataclass
class _LazyService:
    name: str
    methods: List[Tuple]
    extends: List[str]
    doc: str
    visibility: str
    decorators: List[T.DecoratorUsage]


@dataclasses.dataclass
class _LazyConst:
    name: str
    type: T.Type
    raw: object
    doc: str
    visibility: str


def _map_lazy(key: T.Type, value: T.Type) -> T.Type:
    """MapT whose key may be a TypeRef (validated at resolution)."""
    m = object.__new__(T.MapT)
    m.key = key
    m.value = value
    return m


def _fixed_array_lazy(elem: T.Type, count: int) -> T.FixedArray:
    fa = object.__new__(T.FixedArray)
    fa.elem = elem
    fa.count = count
    if not (0 <= count <= T.MAX_FIXED_ARRAY):
        raise ParseError(f"fixed array size out of range: {count}")
    return fa


# --------------------------------------------------------------------------
# Resolution
# --------------------------------------------------------------------------


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(h|m(?!s)|s|ms|us|ns)")


def resolve(schema: Schema) -> Schema:
    """Replace TypeRefs, finalize services and constants, in place."""

    def res_t(t: T.Type) -> T.Type:
        if isinstance(t, TypeRef):
            target = schema.get(t.name)
            if target is None or not isinstance(target, T.Type):
                raise ParseError(f"unresolved type reference {t.name!r}")
            return target
        if isinstance(t, T.FixedArray):
            t.elem = res_t(t.elem)
            return t
        if isinstance(t, T.Array):
            t.elem = res_t(t.elem)
            return t
        if isinstance(t, T.MapT):
            t.key = res_t(t.key)
            t.value = res_t(t.value)
            # validate key now
            T.MapT.__init__(t, t.key, t.value)
            return t
        return t

    for name in list(schema.order):
        d = schema.definitions[name]
        if isinstance(d, (T.Struct, T.Message)):
            for f in d.fields:
                f.type = res_t(f.type)
        elif isinstance(d, T.Union):
            for b in d.branches:
                b.type = res_t(b.type)

    # services after types
    for name in list(schema.order):
        d = schema.definitions[name]
        if isinstance(d, _LazyService):
            extends = []
            for base in d.extends:
                b = schema.get(base)
                if not isinstance(b, ServiceDef):
                    raise ParseError(f"service {name} extends unknown {base}")
                extends.append(b)
            methods = [MethodDef(m, res_t(req), res_t(res),
                                 client_stream=cs, server_stream=ss, doc=doc,
                                 decorators=decs)
                       for (m, req, res, cs, ss, doc, decs) in d.methods]
            svc = ServiceDef(d.name, methods, extends=extends, doc=d.doc,
                             visibility=d.visibility, decorators=d.decorators)
            schema.definitions[name] = svc
        elif isinstance(d, _LazyConst):
            ctype = res_t(d.type)
            value = _const_value(ctype, d.raw)
            schema.definitions[name] = ConstDef(d.name, ctype, value, d.doc,
                                                d.visibility)
    return schema


_ENV_RE = re.compile(r"\$\(([A-Za-z_][A-Za-z0-9_]*)\)")


def _const_value(ctype: T.Type, raw):
    if isinstance(ctype, T.StringT):
        # environment variable substitution (§5.4)
        return _ENV_RE.sub(lambda m: os.environ.get(m.group(1), ""), str(raw))
    if isinstance(ctype, T.Prim) and ctype.name == "timestamp":
        return parse_iso8601(str(raw))
    if isinstance(ctype, T.Prim) and ctype.name == "duration":
        return parse_duration(str(raw))
    if isinstance(ctype, T.Array) and isinstance(raw, (bytes, bytearray)):
        import numpy as np
        return np.frombuffer(bytes(raw), dtype="u1")
    if isinstance(ctype, T.Prim) and ctype.name in T.INTEGER_PRIMS:
        return int(raw)
    if isinstance(ctype, T.Prim) and ctype.name in T.FLOAT_PRIMS:
        return float(raw)
    if isinstance(ctype, T.Prim) and ctype.name == "bool":
        return bool(raw)
    return raw


_ISO_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})[Tt ](\d{2}):(\d{2}):(\d{2})"
    r"(?:\.(\d{1,9}))?"
    r"(Z|z|[+-]\d{2}:\d{2}(?::\d{2}(?:\.\d{1,3})?)?)?$")


def parse_iso8601(s: str) -> T.Timestamp:
    """ISO 8601 with nanosecond precision and ms-precision offsets (§5.4)."""
    m = _ISO_RE.match(s.strip())
    if not m:
        raise ParseError(f"bad timestamp literal {s!r}")
    import calendar
    y, mo, d, h, mi, sec = (int(m.group(i)) for i in range(1, 7))
    frac = m.group(7) or ""
    ns = int(frac.ljust(9, "0")) if frac else 0
    tz = m.group(8)
    offset_ms = 0
    if tz and tz not in ("Z", "z"):
        sign = 1 if tz[0] == "+" else -1
        parts = tz[1:].split(":")
        oh, om = int(parts[0]), int(parts[1])
        osec = float(parts[2]) if len(parts) > 2 else 0.0
        offset_ms = sign * int(round((oh * 3600 + om * 60 + osec) * 1000))
    epoch = calendar.timegm((y, mo, d, h, mi, sec, 0, 0, 0))
    # wall time minus offset = UTC
    epoch -= offset_ms // 1000 if offset_ms % 1000 == 0 else 0
    if offset_ms % 1000:
        # sub-second offset: carry into ns
        total_ns = (epoch * 10**9 + ns) - offset_ms * 10**6
        # recompute after full-precision subtraction
        epoch, ns = divmod(total_ns, 10**9)
    return T.Timestamp(int(epoch), ns, offset_ms)


def parse_duration(s: str) -> T.Duration:
    """Duration suffix literals: "1h30m", "500ms", "10us" (§5.4)."""
    s = s.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    pos = 0
    total_ns = 0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ParseError(f"bad duration literal {s!r}")
        pos = m.end()
        val = float(m.group(1))
        unit = m.group(2)
        mult = {"h": 3600 * 10**9, "m": 60 * 10**9, "s": 10**9,
                "ms": 10**6, "us": 10**3, "ns": 1}[unit]
        total_ns += int(round(val * mult))
    if pos != len(s) or pos == 0:
        raise ParseError(f"bad duration literal {s!r}")
    if neg:
        total_ns = -total_ns
    sec, ns = divmod(abs(total_ns), 10**9)
    if total_ns < 0:
        return T.Duration(-sec, -ns)
    return T.Duration(sec, ns)


def parse_schema(src: str, *, filename: str = "<schema>") -> Schema:
    """Parse + resolve a single self-contained source (no imports)."""
    pf = Parser(src, filename=filename).parse()
    return resolve(pf.schema)
