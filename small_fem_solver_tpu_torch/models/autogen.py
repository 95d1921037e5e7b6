"""Member auto-generation from node-naming conventions (the port's own copy
of ``small_fem_solver_tpu/models/autogen.py``, which is pure Python).

Leg members chain same-letter nodes by level (regex ``^([A-Z])(\\d+)$``),
horizontal braces ring the nodes of each level.  Operates on plain
node/member dicts (the input of ``build_model``), so it composes with
JSON-loaded geometry.
"""
from __future__ import annotations

import re

_LEG_RE = re.compile(r"^([A-Z])(\d+)$")


def auto_generate_legs(nodes: dict, members: list[dict]) -> list[dict]:
    """Append leg members A1->A2->A3... for every leg letter, skipping a
    member whose generated name already exists.  Returns the (mutated)
    member list."""
    legs: dict[str, list[tuple[int, str]]] = {}
    for name in nodes:
        m = _LEG_RE.match(name)
        if m:
            legs.setdefault(m.group(1), []).append((int(m.group(2)), name))
    existing = {m["name"] for m in members}
    for lst in legs.values():
        lst.sort()
        for i in range(len(lst) - 1):
            n1, n2 = lst[i][1], lst[i + 1][1]
            name = f"Leg_{n1}-{n2}"
            if name not in existing:
                members.append({"name": name, "node1": n1, "node2": n2,
                                "type": "leg"})
                existing.add(name)
    return members


def auto_generate_h_braces(nodes: dict, members: list[dict]) -> list[dict]:
    """Append horizontal brace rings per level: the nodes of each level
    sorted by name, each connected to the next (wrapping around)."""
    levels: dict[int, list[str]] = {}
    for name in nodes:
        m = _LEG_RE.match(name)
        if m:
            levels.setdefault(int(m.group(2)), []).append(name)
    existing = {m["name"] for m in members}
    for names in levels.values():
        names.sort()
        for i in range(len(names)):
            n1 = names[i]
            n2 = names[(i + 1) % len(names)]
            name = f"HBrace_{n1}-{n2}"
            if name not in existing:
                members.append({"name": name, "node1": n1, "node2": n2,
                                "type": "h_brace"})
                existing.add(name)
    return members
