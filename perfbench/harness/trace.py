"""The device trace of the traced chunks: ``torch.profiler`` on the card,
reduced to what the per-layer readers and the result line take (kernel
intervals by name, the host's activity, busy and idle seconds, the
breakdown).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np

GAPS_LABELLED = 5000    # the longest idle gaps labelled by the host's activity
NAME_CHARS = 96         # a kernel or host name as the breakdown prints it


class Trace(NamedTuple):
    """Device operations (kernels, copies, sets) and host events of one
    traced window, times in seconds on one clock."""

    dev_name: np.ndarray    # (k,) object
    dev_start: np.ndarray   # (k,) float64
    dev_dur: np.ndarray     # (k,)
    is_kernel: np.ndarray   # (k,) bool: a kernel, not a copy or a set
    host_name: np.ndarray   # (j,) object
    host_start: np.ndarray
    host_dur: np.ndarray
    window_s: float


def _times(ev):
    """(start, duration) of a kineto event in seconds, whichever clock
    accessors this torch has."""
    if hasattr(ev, "start_ns"):
        return ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
    return ev.start_us() * 1e-6, ev.duration_us() * 1e-6


@contextlib.contextmanager
def profiled(on_cuda: bool, host: bool = False):
    """Profile the body; yields a list that holds the :class:`Trace` once
    the body has run (empty if the profiler recorded nothing).  On the card
    it records the card's activity (kernels, copies, sets, and the runtime
    calls that launch them), and with ``host`` every host operation too,
    which at tens of thousands of launches a step about doubles a step's
    time; without a card, the host's."""
    from torch.profiler import ProfilerActivity, profile

    acts = (([ProfilerActivity.CPU] if host or not on_cuda else [])
            + ([ProfilerActivity.CUDA] if on_cuda else []))
    box: list = []
    with profile(activities=acts) as prof:
        yield box
    box.append(reduce_events(prof.profiler.kineto_results.events()))


def reduce_events(events) -> Trace:
    """A :class:`Trace` from kineto events: device-side ones (kernels,
    memcpy, memset) apart from host-side ones."""
    import torch

    dn, ds, dd, kern, hn, hs, hd = [], [], [], [], [], [], []
    for ev in events:
        st, du = _times(ev)
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dn.append(name)
            ds.append(st)
            dd.append(du)
            kern.append(not name.startswith(("Memcpy", "Memset")))
        else:
            hn.append(name)
            hs.append(st)
            hd.append(du)
    ds, dd, hs, hd = (np.asarray(v, dtype=np.float64) for v in (ds, dd, hs, hd))
    starts = np.concatenate([ds, hs])
    ends = np.concatenate([ds + dd, hs + hd])
    window = float(ends.max() - starts.min()) if len(starts) else 0.0
    return Trace(np.asarray(dn, dtype=object), ds, dd, np.asarray(kern, dtype=bool),
                 np.asarray(hn, dtype=object), hs, hd, window)


def busy_and_gaps(tr: Trace):
    """(busy seconds, gap starts, gap lengths): the union of the device's
    operation intervals, and the idle stretches between them."""
    if not len(tr.dev_start):
        return 0.0, np.zeros(0), np.zeros(0)
    order = np.argsort(tr.dev_start, kind="stable")
    st, en = tr.dev_start[order], (tr.dev_start + tr.dev_dur)[order]
    reach = np.maximum.accumulate(en)
    gap = st[1:] - reach[:-1]
    idle = np.where(gap > 0, gap, 0.0)
    busy = float(reach[-1] - st[0] - idle.sum())
    keep = gap > 0
    return busy, reach[:-1][keep], gap[keep]


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def breakdown(tr: Trace, labelled: Trace | None, top: int = 10) -> dict:
    """``device_ops``: the device operations of ``tr`` with the most time,
    summed by name; ``idle_gaps``: the idle time of ``labelled`` (a trace
    with the host's activity) summed by what the host was doing when each
    of the longest gaps began (the innermost host event open at its
    middle), both as [name, seconds], at most ``top`` each."""
    ops: dict = {}
    for name, d in zip(tr.dev_name, tr.dev_dur):
        ops[name] = ops.get(name, 0.0) + float(d)
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    idle_gaps = _labelled_gaps(labelled, top) if labelled is not None else []
    return {"device_ops": [[_short(n), s] for n, s in device_ops],
            "idle_gaps": [[_short(n), s] for n, s in idle_gaps]}


def _labelled_gaps(tr: Trace, top: int) -> list:
    _, g0, glen = busy_and_gaps(tr)
    idle: dict = {}
    if len(glen) and len(tr.host_start):
        pick = np.argsort(-glen)[:GAPS_LABELLED]
        mid = g0[pick] + 0.5 * glen[pick]
        order = np.argsort(tr.host_start, kind="stable")
        hs = tr.host_start[order]
        he = hs + tr.host_dur[order]
        names = tr.host_name[order]
        pos = np.searchsorted(hs, mid, side="right") - 1
        back = pos[:, None] - np.arange(64)[None, :]
        valid = back >= 0
        bi = np.clip(back, 0, None)
        inside = valid & (he[bi] >= mid[:, None])
        first = np.where(inside.any(axis=1), inside.argmax(axis=1), -1)
        for k, f in enumerate(first):
            label = str(names[bi[k, f]]) if f >= 0 else "(no host event)"
            idle[label] = idle.get(label, 0.0) + float(glen[pick[k]])
    return sorted(idle.items(), key=lambda kv: -kv[1])[:top]
