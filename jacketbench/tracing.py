"""The traced run's one profiler session and what is read from it.

One ``torch.profiler`` session spans the whole measured window (a later
session in the same process can lose device records on the H100 host), with
the benchmark's own ``record_function`` span named ``WINDOW`` round it and
one named ``CALL`` round each call.  The events are read raw from Kineto's
results (no event tree is built: a window holds hundreds of thousands of
device operations).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

WINDOW, CALL = "jacketbench.window", "jacketbench.call"


@dataclasses.dataclass
class Trace:
    window_s: float            # the traced window, profiler clock
    names: list                # device operations in the window: names,
    start: np.ndarray          # start and end, ns
    end: np.ndarray
    host_names: list           # host operations (innermost labels)
    host_start: np.ndarray
    host_end: np.ndarray
    calls: list                # per call: {"counters": ..., "work": ...}
    records: dict              # what metric instruments recorded

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    def device_s(self, match) -> float:
        """Seconds of device operations whose name satisfies ``match``."""
        keep = np.fromiter((bool(match(n)) for n in self.names), bool,
                           len(self.names))
        return float((self.end[keep] - self.start[keep]).sum()) * 1e-9

    def busy_intervals(self) -> np.ndarray:
        """The union of device operations' intervals [k, 2] (ns)."""
        if not len(self.start):
            return np.zeros((0, 2), np.int64)
        o = np.argsort(self.start, kind="stable")
        s, e = self.start[o], self.end[o]
        reach = np.maximum.accumulate(e)
        new = np.ones(s.size, bool)
        new[1:] = s[1:] > reach[:-1]
        starts = s[new]
        ends = np.maximum.reduceat(e, np.flatnonzero(new))
        return np.stack([starts, ends], 1)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _ns(ev, which: str) -> int:
    f = getattr(ev, f"{which}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{which}_us")()
                                              * 1000)


def _annotation(ev) -> bool:
    """A ``record_function`` span mirrored on the device timeline."""
    f = getattr(ev, "is_user_annotation", None)
    return ev.name().startswith("jacketbench.") or bool(f and f())


def read(prof, calls: list, records: dict) -> Trace:
    """The device and host operations inside the ``WINDOW`` span."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, win = [], [], None
    for ev in events:
        name = ev.name()
        s, e = _ns(ev, "start"), _ns(ev, "end")
        if ev.device_type() == cuda:
            if not _annotation(ev):
                dev.append((name, s, e))
        elif name == WINDOW:
            win = (s, e)
        else:
            host.append((name, s, e))
    if win is None:
        raise RuntimeError("the profiler recorded no window span")
    dev = [d for d in dev if d[1] >= win[0] and d[2] <= win[1]]
    host = [h for h in host if h[2] > win[0] and h[1] < win[1]]

    def arr(rows, i):
        return np.array([r[i] for r in rows], np.int64)
    return Trace(window_s=(win[1] - win[0]) * 1e-9,
                 names=[d[0] for d in dev], start=arr(dev, 1),
                 end=arr(dev, 2), host_names=[h[0] for h in host],
                 host_start=arr(host, 1), host_end=arr(host, 2),
                 calls=calls, records=records)


def breakdown(tr: Trace, k: int = 10) -> dict:
    """The ``k`` device operations with the most time, and the ``k``
    longest gaps with no device operation, each named by the innermost
    host operation running across its middle."""
    total: dict = {}
    for n, d in zip(tr.names, (tr.end - tr.start) * 1e-9):
        total[n] = total.get(n, 0.0) + float(d)
    ops = sorted(total.items(), key=lambda x: -x[1])[:k]
    iv = tr.busy_intervals()
    gaps = []
    if len(iv) > 1:
        gs, ge = iv[:-1, 1], iv[1:, 0]
        order = np.argsort(gs - ge)[:k]
        for g0, g1 in zip(gs[order], ge[order]):
            mid = (g0 + g1) // 2
            inside = np.flatnonzero((tr.host_start <= mid)
                                    & (tr.host_end >= mid))
            label = "no host operation"
            if inside.size:
                j = inside[np.argmin(tr.host_end[inside]
                                     - tr.host_start[inside])]
                label = tr.host_names[j]
            gaps.append([label[:120], float(g1 - g0) * 1e-9])
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": gaps}
