"""Comparison of two CLI stdouts (the port's and a reference's), shared by
the CLI tests and ``chip_smoke.py``'s CLI phase; no JAX.  The texts agree
when they are equal with every number masked and each number lies within
one unit of its last printed digit (``f32``: within 1e-4 relative, or one
unit, whichever is larger).  Rows of a ranked table whose values tie to
the printed digits (members of a symmetric jacket) may come in either
order."""
import math
import re

# a number as the CLI prints it: sign, digits (thousands commas), decimals,
# exponent
NUMBER = re.compile(r"[-+]?\d[\d,]*(?:\.\d*)?(?:[eE][-+]?\d+)?")
F32_RTOL = 1e-4


def _unit(token: str) -> float:
    """One unit of the last printed digit of ``token``."""
    mant, _, exp = token.replace(",", "").lower().partition("e")
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (-decimals + (int(exp) if exp else 0))


def _numbers_close(ta: list, tb: list, f32: bool) -> list[str]:
    out = []
    for a, b in zip(ta, tb):
        va = float(a.replace(",", "").rstrip("."))
        vb = float(b.replace(",", "").rstrip("."))
        tol = _unit(b) * (1.0 + 1e-9)
        if f32:
            tol = max(tol, F32_RTOL * abs(vb))
        if not (abs(va - vb) <= tol or (math.isnan(va) and math.isnan(vb))):
            out.append(f"{a} != {b} (tolerance {tol:g})")
    return out


def _lines_match(la: str, lb: str, f32: bool) -> bool:
    return (NUMBER.sub("#", la) == NUMBER.sub("#", lb)
            and not _numbers_close(NUMBER.findall(la), NUMBER.findall(lb),
                                   f32))


def text_diff(a: str, b: str, f32: bool = False) -> list[str]:
    """The differences of ``a`` (port) from ``b`` (JAX) under the rule
    above, as readable lines (empty when they agree).  Rows of a ranked
    table whose values tie to the printed digits (members of a symmetric
    jacket) may come in either order: a run of differing lines passes
    when its rows match one to one."""
    la, lb = a.splitlines(), b.splitlines()
    if len(la) != len(lb):
        return [f"{len(la)} lines against {len(lb)}"]
    out, i = [], 0
    while i < len(la):
        if _lines_match(la[i], lb[i], f32):
            i += 1
            continue
        j = i
        while j < len(la) and not _lines_match(la[j], lb[j], f32):
            j += 1
        rest = list(lb[i:j])
        for line in la[i:j]:
            k = next((k for k, r in enumerate(rest)
                      if _lines_match(line, r, f32)), None)
            if k is None:
                out.append(f"line {i}: {line!r}")
                out += _numbers_close(NUMBER.findall(line),
                                      NUMBER.findall(lb[la.index(line)]),
                                      f32)
                break
            rest.pop(k)
        i = j
    return out
