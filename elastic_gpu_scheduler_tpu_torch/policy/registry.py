"""The policy registry of a serving replica: the ``kv`` verb.

Own copy of the ``kv`` verb of ``elastic_gpu_scheduler_tpu/policy/
registry.py``.  An operator hot-loads a policy expression over the verb's
inputs (``KV_INPUTS``) through the replica's ``POST /policy/load``; from
then on it ranks the slots the serving loop may preempt when the KV page
pool is exhausted, and the session that ``/v1/migrate/out`` moves when
none is named (HIGHER score = chosen), until ``POST /policy/rollback``
restores the built-in ranking.  A
runtime fault of the policy (budget, deadline, math) falls back to the
built-in ranking and is counted (``tpu_policy_evals_total{outcome=
"fault"}``, the policy's ``faults``).  The plane costs one dict lookup
while no policy is loaded.

The scheduler's verbs (score, filter, preempt, defrag), the replay gate,
canary promotion and the journal records are control-plane code and stay
in the reference; a ``kv`` policy there, as here, decides every eviction
once loaded.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..metrics import POLICY_EVALS, POLICY_EVENTS
from .lang import compile_expr
from .vm import DEFAULT_BUDGET, PolicyFault, run

__all__ = ["KV_INPUTS", "POLICIES", "PolicyPlane", "VERBS"]

# a slot's inputs: its request's priority, pages held, tokens emitted, its
# index, and the tokens it got from the prefix cache at admission
KV_INPUTS = ("priority", "pages", "tokens", "slot", "matched")
VERB_INPUTS = {"kv": KV_INPUTS}
VERBS = tuple(VERB_INPUTS)


class LoadedPolicy:
    """One compiled policy attached to a verb."""

    def __init__(self, name: str, verb: str, program, source: str):
        self.name = name
        self.verb = verb
        self.program = program
        self.source = source
        self.loaded_at = time.time()
        self.evals = 0
        self.faults = 0
        self.fault_kinds: dict[str, int] = {}

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "verb": self.verb,
            "source": self.source,
            "fingerprint": self.program.fingerprint,
            "budget": self.program.budget,
            "inputs": list(self.program.slots),
            "loaded_at": self.loaded_at,
            "evals": self.evals,
            "faults": self.faults,
            "fault_kinds": dict(self.fault_kinds),
        }


class PolicyPlane:
    """The loaded policies of this process, one a verb."""

    def __init__(self):
        self._lock = threading.Lock()
        self.canary: dict[str, LoadedPolicy] = {}
        self.history: list[dict] = []  # load events

    def reset(self) -> None:
        """Drop every policy (tests)."""
        with self._lock:
            self.canary.clear()
            self.history.clear()

    def load(self, name: str, verb: str, expr: str, budget: int = DEFAULT_BUDGET) -> dict:
        """Compile ``expr`` against the verb's inputs and put it in force
        (a ``kv`` policy has no per-request split, so it decides every
        eviction).  Raises ``lang.CompileError`` for a bad expression and
        ValueError for an unknown verb; the plane is then unchanged."""
        if verb not in VERBS:
            raise ValueError(f"unknown verb {verb!r}; choose from {VERBS}")
        program = compile_expr(expr, VERB_INPUTS[verb], budget=budget)
        pol = LoadedPolicy(name, verb, program, expr)
        POLICY_EVENTS.inc("load")
        with self._lock:
            self.canary[verb] = pol
            self.history.append({"t": time.time(), "event": "canary", "verb": verb,
                                 "name": name, "pct": 100.0})
            del self.history[:-50]
        return {"state": "canary", "name": name, "verb": verb, "canary_pct": 100.0,
                "gate": None}

    def rollback(self, verb: str, reason: str = "operator") -> dict:
        """Drop the verb's policy and restore the built-in ranking.
        Raises ValueError when nothing is loaded for ``verb``."""
        with self._lock:
            pol = self.canary.pop(verb, None)
            if pol is None:
                raise ValueError(f"nothing loaded for verb {verb!r}")
            self.history.append({"t": time.time(), "event": "rollback", "verb": verb,
                                 "name": pol.name, "reason": reason, "auto": False})
            del self.history[:-50]
        POLICY_EVENTS.inc("rollback")
        return {"state": "builtin", "rolled_back": pol.name, "verb": verb, "reason": reason}

    def _eval(self, verb: str, pol: LoadedPolicy, inputs: dict) -> Optional[float]:
        """The policy's score of one input dict, or None on a fault (the
        caller falls back to the built-in)."""
        pol.evals += 1
        try:
            out = run(pol.program, [float(inputs[n]) for n in pol.program.slots])
            POLICY_EVALS.inc(verb, "ok")
            return out
        except PolicyFault as e:
            self.note_fault(verb, pol, e)
            return None
        except Exception as e:
            self.note_fault(verb, pol, PolicyFault("fill", str(e)))
            return None

    def select_kv_victim(self, slots: list[dict]) -> int:
        """The KV-page preemption victim among ``slots`` (dicts of
        KV_INPUTS).  Built-in: the lowest priority, most pages held, then
        the lowest slot.  With a loaded ``kv`` policy: the slot with the
        HIGHEST score, the first on a tie (built-in on any fault)."""
        pol = self.canary.get("kv")
        if pol is not None:
            best = None
            for info in slots:
                s = self._eval("kv", pol, info)
                if s is None:
                    best = None
                    break
                if best is None or s > best[0]:
                    best = (s, int(info["slot"]))
            if best is not None:
                return best[1]
        return int(min(slots, key=lambda i: (i["priority"], -i["pages"], i["slot"]))["slot"])

    def note_fault(self, verb: str, pol: LoadedPolicy, fault: PolicyFault) -> None:
        """Count one runtime fault; the caller has already fallen back."""
        POLICY_EVALS.inc(verb, "fault")
        POLICY_EVENTS.inc("fault")
        pol.faults += 1
        pol.fault_kinds[fault.kind] = pol.fault_kinds.get(fault.kind, 0) + 1

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "verbs": list(VERBS),
                "active": {},
                "canary": {v: dict(p.snapshot(), canary_pct=100.0)
                           for v, p in self.canary.items()},
                "history": list(self.history[-20:]),
                "inputs": {v: list(n) for v, n in VERB_INPUTS.items()},
            }


# the process-global plane the serving loop consults
POLICIES = PolicyPlane()
