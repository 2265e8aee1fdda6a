"""Tenant quarantine with exponential re-admission backoff (repro_torch.sched).

A lane the policy KILLs (``HALT_KILL``) — or one the scheduler evicts for
deny-storming / budget exhaustion — marks its *tenant*, and the tenant's
queued requests then wait out a backoff instead of instantly reclaiming a
slot: ``base * 2^(streak-1)`` generations, doubling per consecutive
offence up to ``cap``, streak reset by a clean (HALT_EXIT) completion.
This is the serving-side analogue of revoking the syscall privilege for a
while rather than forever.
"""
from __future__ import annotations

from typing import Dict, List


class Quarantine:
    def __init__(self, base: int = 2, cap: int = 64):
        assert base >= 1 and cap >= base
        self.base = int(base)
        self.cap = int(cap)
        self._until: Dict[str, int] = {}    # tenant -> first admissible gen
        self._streak: Dict[str, int] = {}   # consecutive offences
        self.events: List[dict] = []

    def punish(self, tenant: str, generation: int, *, reason: str) -> int:
        """Record an offence now; returns the generation the tenant may
        re-admit at (exponential in the offence streak)."""
        streak = self._streak.get(tenant, 0) + 1
        self._streak[tenant] = streak
        backoff = min(self.cap, self.base << (streak - 1))
        until = max(self._until.get(tenant, 0), generation + backoff)
        self._until[tenant] = until
        self.events.append({"tenant": tenant, "generation": generation,
                            "reason": reason, "backoff_gens": backoff,
                            "until_gen": until, "streak": streak})
        return until

    def blocked(self, tenant: str, generation: int) -> bool:
        return generation < self._until.get(tenant, 0)

    def depth(self, generation: int) -> int:
        """How many tenants are still waiting out a backoff."""
        return sum(1 for until in self._until.values() if generation < until)

    def clear(self, tenant: str) -> None:
        """A clean completion resets the offence streak (the next offence
        starts from the base backoff again)."""
        self._streak.pop(tenant, None)

    def state(self) -> dict:
        return {"until": dict(self._until), "streak": dict(self._streak),
                "events": list(self.events)}
