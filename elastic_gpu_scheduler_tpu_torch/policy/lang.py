"""The policy expression language: lexer, parser, compiler.

Own copy of ``elastic_gpu_scheduler_tpu/policy/lang.py``, so a policy
source compiles to the same bytecode, fingerprint and results in a port
replica as in a JAX one.

One expression per policy — no statements, no loops, no assignment.
Grammar (C-ish precedence, short-circuit logical ops and ternary):

    expr    := or ('?' expr ':' expr)?
    or      := and (('or' | '||') and)*
    and     := not (('and' | '&&') not)*
    not     := ('not' | '!') not | cmp
    cmp     := sum (('<' '<=' '>' '>=' '==' '!=') sum)?
    sum     := term (('+' | '-') term)*
    term    := unary (('*' | '/' | '%') unary)*
    unary   := '-' unary | atom
    atom    := NUMBER | NAME | FUNC '(' expr (',' expr)* ')' | '(' expr ')'

Booleans are floats (true = 1.0, false = 0.0; anything non-zero is
truthy).  ``?:``, ``and`` and ``or`` SHORT-CIRCUIT — the untaken branch
is never executed, so ``x != 0 ? y / x : 0`` is total even at x == 0.
Functions: ``min``/``max`` (2+ args), ``abs``, ``floor``, ``ceil``,
``clamp(x, lo, hi)``.  Constants: ``true``, ``false``.

Every NAME must be one of the verb's declared inputs (``registry.py``
declares the ``kv`` verb's); an unknown name is a COMPILE error, so
a typo can never become a silent 0.0 at runtime.  Left-associative
``+``/``*`` compile in source order, so a policy spelling out a
built-in formula scores BIT-IDENTICAL to it.

The compiler parses to a small AST and emits it as stack bytecode for
the :mod:`.vm` interpreter, the canonical form that fingerprints and
the runtime instruction budget and wall deadline apply to.
"""

from __future__ import annotations

import hashlib

from .vm import (
    DEFAULT_BUDGET,
    DEFAULT_DEADLINE_S,
    MAX_BUDGET,
    OP_ABS,
    OP_ADD,
    OP_CEIL,
    OP_CLAMP,
    OP_CONST,
    OP_DIV,
    OP_EQ,
    OP_FLOOR,
    OP_GE,
    OP_GT,
    OP_JMP,
    OP_JMPF,
    OP_LE,
    OP_LOAD,
    OP_LT,
    OP_MAX,
    OP_MIN,
    OP_MOD,
    OP_MUL,
    OP_NE,
    OP_NEG,
    OP_NOT,
    OP_SUB,
    OP_TRUTH,
    Program,
)

MAX_SOURCE = 4096
MAX_TOKENS = 1024
MAX_DEPTH = 32

_FUNCS = {"abs": 1, "floor": 1, "ceil": 1, "min": 2, "max": 2, "clamp": 3}
_FUNC_MAX_ARGS = {"abs": 1, "floor": 1, "ceil": 1, "min": 16, "max": 16,
                  "clamp": 3}
_KEYWORDS = {"and", "or", "not", "true", "false"}
_CMP_OPS = ("<", "<=", ">", ">=", "==", "!=")
_PUNCT = (
    "<=", ">=", "==", "!=", "&&", "||",
    "+", "-", "*", "/", "%", "(", ")", ",", "?", ":", "<", ">", "!",
)


class CompileError(ValueError):
    """Source rejected at compile time (syntax, unknown input, size)."""

    def __init__(self, msg: str, pos: int = -1):
        super().__init__(f"{msg} (at offset {pos})" if pos >= 0 else msg)
        self.pos = pos


def _lex(src: str) -> list[tuple[str, object, int]]:
    """(kind, value, pos) stream; kind in num|name|punct."""
    toks: list[tuple[str, object, int]] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "#":  # comment to end of line
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            while j < n and (src[j].isdigit() or src[j] in ".eE" or (
                src[j] in "+-" and src[j - 1] in "eE"
            )):
                j += 1
            try:
                val = float(src[i:j])
            except ValueError:
                raise CompileError(f"bad number {src[i:j]!r}", i) from None
            toks.append(("num", val, i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            toks.append(("name", src[i:j], i))
            i = j
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(("punct", p, i))
                i += len(p)
                break
        else:
            raise CompileError(f"unexpected character {c!r}", i)
        if len(toks) > MAX_TOKENS:
            raise CompileError(f"expression exceeds {MAX_TOKENS} tokens")
    return toks


# -- parser (tokens → AST) ---------------------------------------------------
#
# AST nodes are plain tuples:
#   ("num", float) ("load", slot) ("neg", a) ("not", a)
#   ("bin", op_str, a, b)  op_str in + - * / % < <= > >= == !=
#   ("and", a, b) ("or", a, b) ("ternary", cond, a, b)
#   ("call", name, [args])


class _Parser:
    def __init__(self, toks, input_names):
        self.toks = toks
        self.pos = 0
        self.input_names = frozenset(input_names)
        self.slots: list[str] = []  # first-use order
        self.slot_idx: dict[str, int] = {}
        self.depth = 0

    def _peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def _next(self):
        t = self._peek()
        if t is None:
            raise CompileError("unexpected end of expression")
        self.pos += 1
        return t

    def _accept(self, *punct):
        t = self._peek()
        if t is not None and t[0] == "punct" and t[1] in punct:
            self.pos += 1
            return t[1]
        return None

    def _accept_name(self, *names):
        t = self._peek()
        if t is not None and t[0] == "name" and t[1] in names:
            self.pos += 1
            return t[1]
        return None

    def _expect(self, punct):
        if self._accept(punct) is None:
            t = self._peek()
            raise CompileError(f"expected {punct!r}", t[2] if t else -1)

    def _enter(self):
        self.depth += 1
        if self.depth > MAX_DEPTH:
            raise CompileError(f"expression nests deeper than {MAX_DEPTH}")

    def expr(self):
        self._enter()
        node = self._or()
        if self._accept("?"):
            then = self.expr()
            self._expect(":")
            node = ("ternary", node, then, self.expr())
        self.depth -= 1
        return node

    def _or(self):
        node = self._and()
        while self._accept("||") or self._accept_name("or"):
            node = ("or", node, self._and())
        return node

    def _and(self):
        node = self._not()
        while self._accept("&&") or self._accept_name("and"):
            node = ("and", node, self._not())
        return node

    def _not(self):
        self._enter()
        if self._accept("!") or self._accept_name("not"):
            node = ("not", self._not())
        else:
            node = self._cmp()
        self.depth -= 1
        return node

    def _cmp(self):
        node = self._sum()
        t = self._peek()
        if t is not None and t[0] == "punct" and t[1] in _CMP_OPS:
            self.pos += 1
            node = ("bin", t[1], node, self._sum())
        return node

    def _sum(self):
        node = self._term()
        while True:
            op = self._accept("+", "-")
            if op is None:
                return node
            node = ("bin", op, node, self._term())

    def _term(self):
        node = self._unary()
        while True:
            op = self._accept("*", "/", "%")
            if op is None:
                return node
            node = ("bin", op, node, self._unary())

    def _unary(self):
        self._enter()
        if self._accept("-"):
            node = ("neg", self._unary())
        else:
            node = self._atom()
        self.depth -= 1
        return node

    def _atom(self):
        t = self._next()
        kind, val, pos = t
        if kind == "num":
            return ("num", float(val))
        if kind == "punct" and val == "(":
            node = self.expr()
            self._expect(")")
            return node
        if kind == "name":
            if val == "true":
                return ("num", 1.0)
            if val == "false":
                return ("num", 0.0)
            if val in _FUNCS:
                self._expect("(")
                args = [self.expr()]
                while self._accept(","):
                    args.append(self.expr())
                self._expect(")")
                lo, hi = _FUNCS[val], _FUNC_MAX_ARGS[val]
                if not lo <= len(args) <= hi:
                    raise CompileError(
                        f"{val}() takes {lo}..{hi} args, got {len(args)}",
                        pos,
                    )
                return ("call", val, args)
            if val in _KEYWORDS:
                raise CompileError(f"misplaced keyword {val!r}", pos)
            if val not in self.input_names:
                raise CompileError(
                    f"unknown input {val!r}; this verb exposes "
                    f"{sorted(self.input_names)}", pos,
                )
            idx = self.slot_idx.get(val)
            if idx is None:
                idx = len(self.slots)
                self.slots.append(val)
                self.slot_idx[val] = idx
            return ("load", idx)
        raise CompileError(f"unexpected token {val!r}", pos)


# -- bytecode emitter (AST → VM code) ----------------------------------------

_BIN_OPS = {
    "+": OP_ADD, "-": OP_SUB, "*": OP_MUL, "/": OP_DIV, "%": OP_MOD,
    "<": OP_LT, "<=": OP_LE, ">": OP_GT, ">=": OP_GE,
    "==": OP_EQ, "!=": OP_NE,
}
_CALL_OPS = {"abs": OP_ABS, "floor": OP_FLOOR, "ceil": OP_CEIL,
             "min": OP_MIN, "max": OP_MAX, "clamp": OP_CLAMP}


class _BytecodeEmitter:
    def __init__(self):
        self.code: list[list] = []
        self.consts: list[float] = []
        self.const_idx: dict[float, int] = {}

    def _emit(self, op, arg=0) -> int:
        self.code.append([op, arg])
        return len(self.code) - 1

    def _const(self, val: float):
        idx = self.const_idx.get(val)
        if idx is None:
            idx = len(self.consts)
            self.consts.append(float(val))
            self.const_idx[val] = idx
        self._emit(OP_CONST, idx)

    def emit(self, node) -> None:
        kind = node[0]
        if kind == "num":
            self._const(node[1])
        elif kind == "load":
            self._emit(OP_LOAD, node[1])
        elif kind == "neg":
            self.emit(node[1])
            self._emit(OP_NEG)
        elif kind == "not":
            self.emit(node[1])
            self._emit(OP_NOT)
        elif kind == "bin":
            self.emit(node[2])
            self.emit(node[3])
            self._emit(_BIN_OPS[node[1]])
        elif kind == "and":
            # a and b → truthy(a) ? truthy(b) : 0   (short-circuit)
            self.emit(node[1])
            jf = self._emit(OP_JMPF)
            self.emit(node[2])
            self._emit(OP_TRUTH)
            je = self._emit(OP_JMP)
            self.code[jf][1] = len(self.code)
            self._const(0.0)
            self.code[je][1] = len(self.code)
        elif kind == "or":
            # a or b → truthy(a) ? 1 : truthy(b)   (short-circuit)
            self.emit(node[1])
            jf = self._emit(OP_JMPF)
            self._const(1.0)
            je = self._emit(OP_JMP)
            self.code[jf][1] = len(self.code)
            self.emit(node[2])
            self._emit(OP_TRUTH)
            self.code[je][1] = len(self.code)
        elif kind == "ternary":
            self.emit(node[1])
            jf = self._emit(OP_JMPF)
            self.emit(node[2])
            je = self._emit(OP_JMP)
            self.code[jf][1] = len(self.code)
            self.emit(node[3])
            self.code[je][1] = len(self.code)
        elif kind == "call":
            fn, args = node[1], node[2]
            for a in args:
                self.emit(a)
            op = _CALL_OPS[fn]
            if fn in ("min", "max"):
                for _ in range(len(args) - 1):
                    self._emit(op)  # left fold
            else:
                self._emit(op)
        else:  # pragma: no cover - parser emits no other kinds
            raise CompileError(f"internal: unknown AST node {kind!r}")


def compile_expr(
    source: str,
    input_names,
    budget: int = DEFAULT_BUDGET,
    deadline_s: float = DEFAULT_DEADLINE_S,
) -> Program:
    """Compile one policy expression against a verb's input table.
    Raises :class:`CompileError`; never executes anything."""
    if not isinstance(source, str) or not source.strip():
        raise CompileError("empty expression")
    if len(source) > MAX_SOURCE:
        raise CompileError(f"source exceeds {MAX_SOURCE} chars")
    budget = max(1, min(int(budget), MAX_BUDGET))
    toks = _lex(source)
    parser = _Parser(toks, input_names)
    ast = parser.expr()
    if parser.pos != len(toks):
        t = parser.toks[parser.pos]
        raise CompileError(f"trailing input {t[1]!r}", t[2])
    em = _BytecodeEmitter()
    em.emit(ast)
    code = tuple((op, arg) for op, arg in em.code)
    consts = tuple(em.consts)
    slots = tuple(parser.slots)
    fp = hashlib.sha256(
        repr((code, consts, slots)).encode()
    ).hexdigest()[:16]
    return Program(
        code=code, consts=consts, slots=slots, source=source,
        budget=budget, deadline_s=float(deadline_s), fingerprint=fp,
    )
