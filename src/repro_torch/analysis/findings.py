"""Finding/report model shared by all analyzers (the port's copy of
``repro.analysis.findings``: the same JSON and text output).

A finding is one rule violation at one location. Severities:

- ``error``: a contract violation that would break correctness (baked
  decode constant, guarded field mutated outside its lock, lock cycle).
- ``warning``: a likely bug or missing hygiene (wait without predicate
  loop, thread without join path). ``--strict`` fails on these too.
- ``info``: advisory context (e.g. donation present but no aliasing
  possible on this platform). Never fails a run.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


class Severity:
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    _ORDER = {"error": 0, "warning": 1, "info": 2}

    @classmethod
    def rank(cls, sev: str) -> int:
        return cls._ORDER.get(sev, 99)


@dataclass(frozen=True)
class Finding:
    rule: str  # e.g. "BAKED-CONST", "CONC-GUARD"
    severity: str  # Severity.*
    location: str  # "path/to/file.py:123" or a program-cell id
    message: str

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "location": self.location,
            "message": self.message,
        }

    def render(self) -> str:
        return f"[{self.severity}] {self.rule} {self.location}: {self.message}"


@dataclass
class Report:
    findings: list[Finding] = field(default_factory=list)
    # Free-form analyzer stats (program counts, trace bounds, files linted)
    # carried into the JSON output for tooling.
    stats: dict = field(default_factory=dict)

    def add(self, rule: str, severity: str, location: str, message: str) -> None:
        self.findings.append(Finding(rule, severity, location, message))

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.stats.update(other.stats)

    def sorted_findings(self) -> list[Finding]:
        return sorted(
            self.findings,
            key=lambda f: (Severity.rank(f.severity), f.location, f.rule),
        )

    def count(self, severity: str) -> int:
        return sum(1 for f in self.findings if f.severity == severity)

    def failed(self, strict: bool = True) -> bool:
        """Whether this report should fail the run.

        Errors always fail; warnings fail only in strict mode; info never
        fails.
        """
        if self.count(Severity.ERROR):
            return True
        return strict and self.count(Severity.WARNING) > 0

    def render_text(self, show_info: bool = False) -> str:
        lines = [
            f.render()
            for f in self.sorted_findings()
            if show_info or f.severity != Severity.INFO
        ]
        lines.append(
            "analysis: %d error(s), %d warning(s), %d info"
            % (
                self.count(Severity.ERROR),
                self.count(Severity.WARNING),
                self.count(Severity.INFO),
            )
        )
        for key in sorted(self.stats):
            lines.append(f"  {key}: {self.stats[key]}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(
            {
                "findings": [f.to_dict() for f in self.sorted_findings()],
                "stats": self.stats,
                "counts": {
                    "error": self.count(Severity.ERROR),
                    "warning": self.count(Severity.WARNING),
                    "info": self.count(Severity.INFO),
                },
            },
            indent=2,
            default=str,
        )
