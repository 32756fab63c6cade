"""Compile-time decorator execution (§5.13).

The paper embeds Lua for `validate [[ ... ]]` / `export [[ ... ]]` blocks.
This module implements a small, sandboxed Lua-subset interpreter sufficient
for the paper's examples and our schemas:

  * statements: `local a, b = e1, e2`, assignment, `return e`,
    `if e then ... [else ...] end`, `error(e)`
  * expressions: nil/true/false, numbers, strings, `..` concat, arithmetic,
    comparisons (== ~= < <= > >=), and/or/not, member access `a.b`,
    indexing `a[k]`, table constructors `{k = v, ["k"] = v, v}`, parentheses
  * builtins: `error`, `tostring`, `tonumber`, `type`

There is no I/O, no loops, no function definitions — blocks are pure
computations over the decorator parameters and the `target` table
(kind / name / parent), exactly the §5.13 contract.

Copied unchanged from the JAX package's ``core/decorators.py``: the
interpreter's number, string and ``and``/``or`` rules decide what a
decorator exports, and both packages must export the same values.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from . import types as T
from .schema import DecoratorDef, Schema


class DecoratorError(T.SchemaError):
    pass


class LuaError(DecoratorError):
    """Raised by `error(...)` inside a validate block."""


# --------------------------------------------------------------------------
# Tokenizer
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\.\.|==|~=|<=|>=|[+\-*/%<>=(){}\[\],.#])
""", re.VERBOSE)

_KEYWORDS = {"local", "return", "if", "then", "else", "elseif", "end", "and",
             "or", "not", "nil", "true", "false"}


def _tokenize(src: str) -> List[Tuple[str, str]]:
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise DecoratorError(f"lua: bad character {src[pos]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        kind = m.lastgroup
        text = m.group()
        if kind == "name" and text in _KEYWORDS:
            toks.append(("kw", text))
        else:
            toks.append((kind, text))
    toks.append(("eof", ""))
    return toks


# --------------------------------------------------------------------------
# Parser (statements -> tuple AST)
# --------------------------------------------------------------------------


class _P:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        if t[0] != "eof":
            self.i += 1
        return t

    def accept(self, kind, text=None):
        k, v = self.peek()
        if k == kind and (text is None or v == text):
            self.next()
            return True
        return False

    def expect(self, kind, text=None):
        k, v = self.next()
        if k != kind or (text is not None and v != text):
            raise DecoratorError(f"lua: expected {text or kind}, got {v!r}")
        return v

    # statements ---------------------------------------------------------
    def block(self, terminators=("eof",)) -> list:
        stmts = []
        while True:
            k, v = self.peek()
            if k == "eof" or (k == "kw" and v in terminators):
                return stmts
            stmts.append(self.statement())

    def statement(self):
        k, v = self.peek()
        if k == "kw" and v == "local":
            self.next()
            names = [self.expect("name")]
            while self.accept("op", ","):
                names.append(self.expect("name"))
            self.expect("op", "=")
            exprs = [self.expr()]
            while self.accept("op", ","):
                exprs.append(self.expr())
            return ("local", names, exprs)
        if k == "kw" and v == "return":
            self.next()
            return ("return", self.expr())
        if k == "kw" and v == "if":
            return self.if_stmt()
        # assignment or bare call
        target = self.expr()
        if self.accept("op", "="):
            value = self.expr()
            return ("assign", target, value)
        return ("exprstmt", target)

    def if_stmt(self):
        self.expect("kw", "if")
        cond = self.expr()
        self.expect("kw", "then")
        then = self.block(("else", "elseif", "end"))
        k, v = self.peek()
        if v == "elseif":
            # rewrite elseif as nested if
            self.toks[self.i] = ("kw", "if")
            other = [self.if_stmt()]
            return ("if", cond, then, other)
        if v == "else":
            self.next()
            other = self.block(("end",))
            self.expect("kw", "end")
            return ("if", cond, then, other)
        self.expect("kw", "end")
        return ("if", cond, then, [])

    # expressions: precedence climbing ------------------------------------
    _PREC = [("or",), ("and",), ("==", "~=", "<", "<=", ">", ">="),
             ("..",), ("+", "-"), ("*", "/", "%")]

    def expr(self, level: int = 0):
        if level == len(self._PREC):
            return self.unary()
        left = self.expr(level + 1)
        ops = self._PREC[level]
        while True:
            k, v = self.peek()
            if (k == "op" and v in ops) or (k == "kw" and v in ops):
                self.next()
                right = self.expr(level + 1 if v != ".." else level)
                left = ("binop", v, left, right)
                if v == "..":
                    return left  # right-assoc handled by recursion
            else:
                return left

    def unary(self):
        k, v = self.peek()
        if k == "kw" and v == "not":
            self.next()
            return ("not", self.unary())
        if k == "op" and v == "-":
            self.next()
            return ("neg", self.unary())
        if k == "op" and v == "#":
            self.next()
            return ("len", self.unary())
        return self.postfix()

    def postfix(self):
        e = self.primary()
        while True:
            if self.accept("op", "."):
                e = ("index", e, ("const", self.expect("name")))
            elif self.accept("op", "["):
                e = ("index", e, self.expr())
                self.expect("op", "]")
            elif self.accept("op", "("):
                args = []
                if not self.accept("op", ")"):
                    args.append(self.expr())
                    while self.accept("op", ","):
                        args.append(self.expr())
                    self.expect("op", ")")
                e = ("call", e, args)
            else:
                return e

    def primary(self):
        k, v = self.next()
        if k == "num":
            return ("const", float(v) if "." in v else int(v))
        if k == "str":
            body = v[1:-1]
            body = re.sub(r"\\(.)", lambda m: {"n": "\n", "t": "\t"}.get(
                m.group(1), m.group(1)), body)
            return ("const", body)
        if k == "kw" and v == "nil":
            return ("const", None)
        if k == "kw" and v in ("true", "false"):
            return ("const", v == "true")
        if k == "name":
            return ("name", v)
        if k == "op" and v == "(":
            e = self.expr()
            self.expect("op", ")")
            return e
        if k == "op" and v == "{":
            items = []
            n = 1
            while not self.accept("op", "}"):
                tk, tv = self.peek()
                if tk == "name" and self.toks[self.i + 1] == ("op", "="):
                    key = ("const", tv)
                    self.next()
                    self.next()
                    items.append((key, self.expr()))
                elif tk == "op" and tv == "[":
                    self.next()
                    key = self.expr()
                    self.expect("op", "]")
                    self.expect("op", "=")
                    items.append((key, self.expr()))
                else:
                    items.append((("const", n), self.expr()))
                    n += 1
                self.accept("op", ",")
            return ("table", items)
        raise DecoratorError(f"lua: unexpected token {v!r}")


# --------------------------------------------------------------------------
# Evaluator
# --------------------------------------------------------------------------


class _Return(Exception):
    def __init__(self, value):
        self.value = value


def _lua_tostring(v) -> str:
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


_BUILTINS = {
    "tostring": _lua_tostring,
    "tonumber": lambda v: float(v) if not isinstance(v, (int, float)) else v,
    "type": lambda v: ("nil" if v is None else "boolean" if isinstance(v, bool)
                       else "number" if isinstance(v, (int, float))
                       else "string" if isinstance(v, str) else "table"),
}


def _error_builtin(msg):
    raise LuaError(_lua_tostring(msg))


def _truthy(v) -> bool:
    return v is not None and v is not False


def _eval(node, env: Dict[str, Any]):
    op = node[0]
    if op == "const":
        return node[1]
    if op == "name":
        name = node[1]
        if name in env:
            return env[name]
        if name in _BUILTINS:
            return _BUILTINS[name]
        if name == "error":
            return _error_builtin
        return None  # unknown names are nil, Lua semantics
    if op == "index":
        obj = _eval(node[1], env)
        key = _eval(node[2], env)
        if obj is None:
            raise DecoratorError(f"lua: indexing nil with {key!r}")
        if isinstance(obj, dict):
            return obj.get(key)
        raise DecoratorError(f"lua: cannot index {type(obj).__name__}")
    if op == "call":
        fn = _eval(node[1], env)
        args = [_eval(a, env) for a in node[2]]
        if not callable(fn):
            raise DecoratorError("lua: calling a non-function")
        return fn(*args)
    if op == "table":
        out = {}
        for k, v in node[1]:
            out[_eval(k, env)] = _eval(v, env)
        return out
    if op == "not":
        return not _truthy(_eval(node[1], env))
    if op == "neg":
        return -_eval(node[1], env)
    if op == "len":
        v = _eval(node[1], env)
        return len(v)
    if op == "binop":
        o = node[1]
        if o == "and":
            left = _eval(node[2], env)
            return _eval(node[3], env) if _truthy(left) else left
        if o == "or":
            left = _eval(node[2], env)
            return left if _truthy(left) else _eval(node[3], env)
        a, b = _eval(node[2], env), _eval(node[3], env)
        if o == "..":
            return _lua_tostring(a) + _lua_tostring(b)
        if o == "==":
            return a == b
        if o == "~=":
            return a != b
        if o == "<":
            return a < b
        if o == "<=":
            return a <= b
        if o == ">":
            return a > b
        if o == ">=":
            return a >= b
        if o == "+":
            return a + b
        if o == "-":
            return a - b
        if o == "*":
            return a * b
        if o == "/":
            return a / b
        if o == "%":
            return a % b
    raise DecoratorError(f"lua: bad node {op}")


def _exec_block(stmts, env) -> Any:
    for s in stmts:
        kind = s[0]
        if kind == "local":
            names, exprs = s[1], s[2]
            vals = [_eval(e, env) for e in exprs]
            while len(vals) < len(names):
                vals.append(None)
            for nm, v in zip(names, vals):
                env[nm] = v
        elif kind == "assign":
            target, value = s[1], s[2]
            v = _eval(value, env)
            if target[0] == "name":
                env[target[1]] = v
            elif target[0] == "index":
                obj = _eval(target[1], env)
                key = _eval(target[2], env)
                obj[key] = v
            else:
                raise DecoratorError("lua: bad assignment target")
        elif kind == "return":
            raise _Return(_eval(s[1], env))
        elif kind == "if":
            _, cond, then, other = s
            branch = then if _truthy(_eval(cond, env)) else other
            _exec_block(branch, env)
        elif kind == "exprstmt":
            _eval(s[1], env)
    return None


def run_lua(src: str, env: Dict[str, Any]) -> Any:
    """Execute a decorator block; returns the `return` value (or None)."""
    stmts = _P(_tokenize(src)).block()
    try:
        _exec_block(stmts, dict(env))
    except _Return as r:
        return r.value
    return None


# --------------------------------------------------------------------------
# Decorator application over a schema
# --------------------------------------------------------------------------

_PARAM_COERCE = {
    "bool": bool, "string": str, "int32": int, "uint32": int, "int64": int,
    "uint64": int, "float32": float, "float64": float,
}


def _check_args(d: DecoratorDef, usage: T.DecoratorUsage) -> Dict[str, Any]:
    args: Dict[str, Any] = {}
    for p in d.params:
        if p.name in usage.args:
            coerce = _PARAM_COERCE.get(p.type_name, lambda v: v)
            args[p.name] = coerce(usage.args[p.name])
        elif p.required:
            raise DecoratorError(
                f"decorator @{d.name}: missing required param {p.name!r}")
        else:
            args[p.name] = None
    for k in usage.args:
        if d.param(k) is None:
            raise DecoratorError(f"decorator @{d.name}: unknown param {k!r}")
    return args


def _target_table(kind: str, name: str, parent: str) -> Dict[str, str]:
    return {"kind": kind, "name": name, "parent": parent}


def _apply_one(schema: Schema, usage: T.DecoratorUsage, kind: str,
               name: str, parent: str) -> None:
    d = schema.decorator_defs.get(usage.name)
    if d is None:
        raise DecoratorError(f"unknown decorator @{usage.name}")
    if "ALL" not in d.targets and kind not in d.targets:
        raise DecoratorError(
            f"decorator @{d.name} targets {d.targets}, applied to {kind}")
    args = _check_args(d, usage)
    env = dict(args)
    env["target"] = _target_table(kind, name, parent)
    if d.validate_src:
        run_lua(d.validate_src, env)  # error() raises LuaError
    if d.export_src:
        out = run_lua(d.export_src, env)
        if out is not None and not isinstance(out, dict):
            raise DecoratorError(
                f"decorator @{d.name}: export must return a table")
        usage.exported = out
    usage.args = args


def apply_decorators(schema: Schema) -> None:
    """Run validate/export for every decorator usage in the schema."""
    from .schema import ServiceDef
    for name, d in schema.definitions.items():
        if isinstance(d, T.Type) and hasattr(d, "decorators"):
            kind = {"Struct": "STRUCT", "Message": "MESSAGE",
                    "Union": "UNION", "Enum": "ENUM"}.get(
                        type(d).__name__, type(d).__name__.upper())
            for u in getattr(d, "decorators", []):
                _apply_one(schema, u, kind, name, "")
            if isinstance(d, (T.Struct, T.Message)):
                for f in d.fields:
                    for u in f.decorators:
                        _apply_one(schema, u, "FIELD", f.name, name)
        elif isinstance(d, ServiceDef):
            for u in d.decorators:
                _apply_one(schema, u, "SERVICE", name, "")
            for m in d.methods:
                for u in m.decorators:
                    _apply_one(schema, u, "METHOD", m.name, name)
