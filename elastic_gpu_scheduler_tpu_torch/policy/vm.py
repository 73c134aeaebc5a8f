"""Deterministic stack VM for hot-loaded policies.

Own copy of ``elastic_gpu_scheduler_tpu/policy/vm.py``: the same
instruction set, budgets and fault kinds, so a policy source compiles and
scores identically in a port replica and in a JAX one.  A loaded policy
must never take its caller down with it, so the execution model is tiny:

- straight-line stack bytecode compiled from a restricted expression
  language (``lang.py``): the instruction set has no loops, so every
  program terminates;
- an INSTRUCTION BUDGET (default 512, at most 4096) counted per executed
  instruction, and a per-evaluation WALL DEADLINE checked every 64
  instructions: a pathological program trips :class:`PolicyFault`;
- typed read-only inputs: a flat float vector laid out by the compiler's
  slot table; a program reaches nothing its verb did not expose;
- determinism: float arithmetic only; division or modulo by zero and
  non-finite results fault rather than propagate.

Faults never escape to the caller: the registry catches
:class:`PolicyFault`, counts it and falls back to the built-in ranking.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

# -- instruction set ---------------------------------------------------------

(
    OP_CONST,   # push consts[arg]
    OP_LOAD,    # push inputs[arg]
    OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MOD,
    OP_NEG, OP_NOT, OP_TRUTH,
    OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NE,
    OP_JMP,     # pc = arg
    OP_JMPF,    # pop; falsy → pc = arg
    OP_MIN, OP_MAX, OP_ABS, OP_FLOOR, OP_CEIL,
    OP_CLAMP,   # pop hi, lo, x → push min(max(x, lo), hi)
) = range(24)

DEFAULT_BUDGET = 512
MAX_BUDGET = 4096
DEFAULT_DEADLINE_S = 0.002  # 2 ms: generous against the microseconds an
# evaluation takes, tight against its caller's own budget
_DEADLINE_STRIDE = 64  # instructions between perf_counter checks


class PolicyFault(Exception):
    """A policy program failed AT RUNTIME (budget, deadline, math, or a
    malformed stack).  The registry catches this and falls back to the
    built-in ranking."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"{kind}: {detail}" if detail else kind)
        self.kind = kind
        self.detail = detail


@dataclass(frozen=True)
class Program:
    """Compiled policy bytecode.  Immutable; safe to share across
    threads (the VM keeps all mutable state on its own stack)."""

    code: tuple  # ((op, arg), ...)
    consts: tuple  # float literals
    slots: tuple  # input names in LOAD-slot order (first-use assigned)
    source: str
    budget: int = DEFAULT_BUDGET
    deadline_s: float = DEFAULT_DEADLINE_S
    fingerprint: str = field(default="", compare=False)


def run(program: Program, inputs) -> float:
    """Evaluate ``program`` over the input vector (floats, laid out per
    ``program.slots``).  Raises :class:`PolicyFault` on budget trip,
    deadline trip, math fault (div/mod by zero, non-finite result) or a
    malformed program.  The hot loop allocates only Python floats and
    one stack list."""
    code = program.code
    consts = program.consts
    budget = program.budget
    deadline_s = program.deadline_s
    stack: list = []
    push = stack.append
    pop = stack.pop
    pc = 0
    ncode = len(code)
    executed = 0
    t0 = time.perf_counter() if deadline_s else 0.0
    try:
        while pc < ncode:
            executed += 1
            if executed > budget:
                raise PolicyFault(
                    "budget", f"exceeded {budget} instructions"
                )
            if deadline_s and executed % _DEADLINE_STRIDE == 0:
                if time.perf_counter() - t0 > deadline_s:
                    raise PolicyFault(
                        "deadline", f"exceeded {deadline_s * 1e3:.1f}ms"
                    )
            op, arg = code[pc]
            pc += 1
            if op == OP_LOAD:
                push(inputs[arg])
            elif op == OP_CONST:
                push(consts[arg])
            elif op == OP_ADD:
                b = pop(); push(pop() + b)
            elif op == OP_SUB:
                b = pop(); push(pop() - b)
            elif op == OP_MUL:
                b = pop(); push(pop() * b)
            elif op == OP_DIV:
                b = pop()
                if b == 0.0:
                    raise PolicyFault("math", "division by zero")
                push(pop() / b)
            elif op == OP_MOD:
                b = pop()
                if b == 0.0:
                    raise PolicyFault("math", "modulo by zero")
                push(math.fmod(pop(), b))
            elif op == OP_NEG:
                push(-pop())
            elif op == OP_NOT:
                push(1.0 if pop() == 0.0 else 0.0)
            elif op == OP_TRUTH:
                push(0.0 if pop() == 0.0 else 1.0)
            elif op == OP_LT:
                b = pop(); push(1.0 if pop() < b else 0.0)
            elif op == OP_LE:
                b = pop(); push(1.0 if pop() <= b else 0.0)
            elif op == OP_GT:
                b = pop(); push(1.0 if pop() > b else 0.0)
            elif op == OP_GE:
                b = pop(); push(1.0 if pop() >= b else 0.0)
            elif op == OP_EQ:
                b = pop(); push(1.0 if pop() == b else 0.0)
            elif op == OP_NE:
                b = pop(); push(1.0 if pop() != b else 0.0)
            elif op == OP_JMP:
                pc = arg
            elif op == OP_JMPF:
                if pop() == 0.0:
                    pc = arg
            elif op == OP_MIN:
                b = pop(); a = pop(); push(a if a <= b else b)
            elif op == OP_MAX:
                b = pop(); a = pop(); push(a if a >= b else b)
            elif op == OP_ABS:
                push(abs(pop()))
            elif op == OP_FLOOR:
                push(float(math.floor(pop())))
            elif op == OP_CEIL:
                push(float(math.ceil(pop())))
            elif op == OP_CLAMP:
                hi = pop(); lo = pop(); x = pop()
                if x < lo:
                    x = lo
                if x > hi:
                    x = hi
                push(x)
            else:  # pragma: no cover - compiler never emits unknown ops
                raise PolicyFault("op", f"unknown opcode {op}")
    except IndexError:
        raise PolicyFault("stack", "stack underflow") from None
    except OverflowError:
        raise PolicyFault("math", "overflow") from None
    if len(stack) != 1:
        raise PolicyFault("stack", f"ended with {len(stack)} values")
    result = stack[0]
    if not math.isfinite(result):
        raise PolicyFault("math", "non-finite result")
    return result
