"""Hot-loaded policies of a serving replica (own copy of the reference's
``policy/`` language, VM and the registry's ``kv`` verb): an operator
loads a small deterministic expression, compiled to budgeted stack
bytecode, that ranks the KV-page preemption victims without a redeploy.
"""

from .lang import CompileError, compile_expr
from .registry import KV_INPUTS, POLICIES, PolicyPlane
from .vm import PolicyFault, Program, run

__all__ = [
    "CompileError",
    "KV_INPUTS",
    "POLICIES",
    "PolicyFault",
    "PolicyPlane",
    "Program",
    "compile_expr",
    "run",
]
