"""Finding/Rule dataclasses — the currency every pass trades in."""
from __future__ import annotations

import dataclasses

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One checkable rule: stable id, severity, one-line summary."""

    id: str
    severity: str
    summary: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in "
                             f"{SEVERITIES}")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``snippet`` is the stripped source line — it doubles as the
    line-drift-tolerant baseline match key (``baseline.py``).
    """

    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule, self.message)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.severity}] {self.rule}: {self.message}")
