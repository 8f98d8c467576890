"""Structured findings: the result schema of the serving preflight (the
port's copy of paddle_tpu/analysis/findings.py's Finding and Findings).

A Finding is one fact about a request or a configuration: a prompt that
would need another prefill shape, a request the block pool can never hold,
a budget that asks for nothing. `ServingEngine.preflight` returns them in
a Findings collection, and `submit` refuses with the first one's code.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

#: severity order
SEVERITIES = ("info", "warn", "error")


@dataclass
class Finding:
    """One result.

    pass_name: which check produced it (config | recompile_hazard).
    code: short machine-matchable slug within the check ("kv_oom",
        "prompt_shape", "max_new_tokens").
    severity: "error" (unservable), "warn" (probable hazard), "info".
    message: one human sentence; says what AND where.
    where: the location, when there is one.
    executable: the executable or component the finding is about.
    data: check-specific details (lengths, row counts, owners).
    allowed/allow_reason: set when an allowlist entry matched.
    """
    pass_name: str
    code: str
    severity: str
    message: str
    where: str = ""
    executable: str = ""
    data: Dict = field(default_factory=dict)
    allowed: bool = False
    allow_reason: Optional[str] = None

    def to_dict(self) -> dict:
        d = {"pass": self.pass_name, "code": self.code,
             "severity": self.severity, "message": self.message}
        if self.where:
            d["where"] = self.where
        if self.executable:
            d["executable"] = self.executable
        if self.data:
            d["data"] = self.data
        if self.allowed:
            d["allowed"] = True
            d["allow_reason"] = self.allow_reason
        return d

    def __str__(self):
        tag = f"[{self.pass_name}:{self.code}]"
        loc = f" @ {self.where}" if self.where else ""
        ex = f" in {self.executable}" if self.executable else ""
        allow = f" (allowed: {self.allow_reason})" if self.allowed else ""
        return f"{self.severity.upper()} {tag} {self.message}{loc}{ex}{allow}"


class Findings:
    """An ordered collection of Finding with filtering."""

    def __init__(self, items: Optional[Sequence[Finding]] = None):
        self.items: List[Finding] = list(items or [])

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __bool__(self):
        return bool(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def add(self, *findings: Finding) -> "Findings":
        self.items.extend(findings)
        return self

    def extend(self, other) -> "Findings":
        self.items.extend(list(other))
        return self

    def for_pass(self, pass_name: str) -> "Findings":
        return Findings([f for f in self.items if f.pass_name == pass_name])

    def active(self, min_severity: str = "warn") -> "Findings":
        """Non-allowlisted findings at/above the severity threshold."""
        lvl = SEVERITIES.index(min_severity)
        return Findings([f for f in self.items if not f.allowed
                         and SEVERITIES.index(f.severity) >= lvl])

    def to_dicts(self) -> List[dict]:
        return [f.to_dict() for f in self.items]


class ConfigValidationError(ValueError):
    """A configuration the engine cannot serve, carrying the Finding that
    says why (a ValueError, so `except ValueError` callers keep
    working)."""

    def __init__(self, finding: Finding):
        self.finding = finding
        super().__init__(str(finding))
