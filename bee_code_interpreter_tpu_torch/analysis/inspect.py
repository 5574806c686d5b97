"""Import-alias resolution over ``ast``: the port's own copy of
``collect_aliases`` and ``resolve_call_name`` of the JAX package's
``analysis/inspect.py`` (its dependency guessing and submission
inspection are not needed here), so ``analysis/torchlint.py`` can match
``import torch.nn.functional as F; F.softmax(...)`` as
``torch.nn.functional.softmax``.
"""

from __future__ import annotations

import ast


def collect_aliases(tree: ast.AST) -> dict[str, str]:
    """{local name: dotted target} for every import binding in the tree —
    ``import a.b`` binds ``a``→``a``, ``import a.b as c`` binds ``c``→``a.b``,
    ``from a import b as c`` binds ``c``→``a.b``. Relative imports resolve
    to nothing useful for policy and are skipped."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    aliases[alias.asname] = alias.name
                else:
                    aliases[alias.name.split(".", 1)[0]] = alias.name.split(
                        ".", 1
                    )[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            for alias in node.names:
                aliases[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}"
                )
    return aliases


def resolve_call_name(
    func: ast.expr, aliases: dict[str, str] | None = None
) -> str | None:
    """Dotted name of a call target, resolved through import aliases.
    ``None`` when the root isn't a plain name (``self.x()``, ``f()()``,
    subscripts) — those can't be matched against a module-path policy and
    must not be guessed at."""
    parts: list[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = node.id
    if aliases and root in aliases:
        root = aliases[root]
    parts.append(root)
    return ".".join(reversed(parts))
