"""The one traffic generator: it reads a traffic mix (``traffic/<name>.json``)
and draws every call's inputs from the seed.

A mix states:

- ``waves``: the wave set that set-up builds, ``{"H_m": <draw>}`` with
  ``{"uniform": [lo, hi], "count": n}`` (a seeded pool) or
  ``{"linspace": [lo, hi, n]}`` (a fixed set); period, depth, current and
  theory are the configuration's;
- ``cases`` (optional): ``{"cross_headings_deg": {"arange": [a, b, step]}}``
  makes the case grid every wave x every heading (wave = current);
- ``call``: what each call draws:
  ``{"draw_waves": k}`` k distinct waves of the pool, each under a heading
  drawn from ``{"heading_grid_deg": [a, b, step]}``; or ``{"grid": true}``
  the whole case grid, its headings offset by one draw from
  ``{"heading_offset_deg": {"uniform": [lo, hi]}}``;
- ``n_steps`` (phases a period), ``case`` (load-case
  settings the mix adds, such as ``slam_cs``), ``entry`` (the program
  entry, ``entries/<entry>.py``) and ``entry_options``, ``warmup_calls``
  (calls in set-up) and ``sample_calls`` (calls checked against the
  reference after the window).

Calls are numbered from 0 in the window; warm-up calls draw from a stream
of their own.  The same seed gives the same calls in the same order.
"""
from __future__ import annotations

import numpy as np

WINDOW, WARMUP, POOL, SAMPLE = 1, 3, 0, 2


def seed_words(seed: int) -> list:
    """A seed (any integer) as non-negative words for numpy's SeedSequence."""
    s = int(seed)
    return [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, 1 if s < 0 else 0]


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    return np.random.default_rng(seed_words(seed) + [stream, *more])


def _draw(spec: dict, g: np.random.Generator) -> np.ndarray:
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return g.uniform(lo, hi, spec.get("count", 1))
    if "linspace" in spec:
        return np.linspace(*spec["linspace"])
    raise ValueError(f"unknown draw {spec!r}")


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, int(seed)
        self.H = _draw(mix["waves"]["H_m"], rng(seed, POOL))
        cross = mix.get("cases", {}).get("cross_headings_deg")
        self.grid_headings = (None if cross is None
                              else np.arange(*cross["arange"], dtype=float))
        self.n_steps = int(mix["n_steps"])

    def call(self, i: int, warmup: bool = False) -> dict:
        """Inputs of call ``i``: wave indices [C] and headings [C]
        (deg)."""
        g = rng(self.seed, WARMUP if warmup else WINDOW, i)
        c = self.mix["call"]
        if c.get("grid"):
            nh = self.grid_headings.size
            idx = np.repeat(np.arange(self.H.size), nh)
            off = _draw(c["heading_offset_deg"], g)[0]
            head = np.tile(self.grid_headings, self.H.size) + off
        else:
            idx = g.choice(self.H.size, c["draw_waves"], replace=False)
            grid = np.arange(c["heading_grid_deg"][0],
                             c["heading_grid_deg"][1] + 1e-9,
                             c["heading_grid_deg"][2])
            head = g.choice(grid, idx.size)
        return {"index": i, "wave_idx": idx, "heading_deg": head,
                "n_steps": self.n_steps}

    def work(self, spec: dict) -> int:
        """(case, phase) solutions a call asks for."""
        return int(spec["wave_idx"].size * spec["n_steps"])


class Reservoir:
    """A seeded uniform sample of ``k`` of the window's calls, whatever
    their number (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k, self.kept, self.g = k, [], rng(seed, SAMPLE)

    def offer(self, i: int, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.g.integers(0, i + 1))
            if j < self.k:
                self.kept[j] = item
