"""A lint finding and a justified exception to one: the port's own copy
of ``Violation`` and ``Suppression`` of the JAX package's
``analysis/asynclint.py``, with the same contract (an entry names its
file, its rule and why; the lint reports an entry no finding matches as
stale).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Violation:
    path: str  # repo-relative
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class Suppression:
    """One justified exception. ``path`` is a suffix match against the
    repo-relative file path; ``rule`` must match exactly. ``contains``
    (optional) narrows the entry to violations whose MESSAGE contains the
    substring — without it a file+rule entry sanctions every future
    violation of that rule in the file."""

    path: str
    rule: str
    reason: str
    contains: str | None = None

    def matches(self, v: Violation) -> bool:
        return (
            v.rule == self.rule
            and v.path.endswith(self.path)
            and (self.contains is None or self.contains in v.message)
        )
