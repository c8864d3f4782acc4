"""The traced run: the profiler over the window, reduced to what the
per-layer readers read.

* host spans: every ``record_function`` range on the host, the
  program's (``host.schedule``, ``cgm.boundary``, ...) and the
  benchmark's own (``perfbench.*``) around its calls into the program;
* device intervals: every kernel, copy and fill on the card, their
  union inside the window (busy seconds) and the gaps between them,
  each named by the innermost host span open where it starts;
* launches: the bound seconds of each launch of a roofline kernel,
  from the shapes its program wrapper was called with
  (:class:`LaunchRecorder`).
"""
from __future__ import annotations

import collections
import contextlib
import sys

import numpy as np

from . import roofline

WINDOW_SPAN = "perfbench.window"
#: the measured program's package
PROGRAM = "repro_torch"


class LaunchRecorder:
    """Wraps the program's kernel wrappers named in
    :data:`roofline.DEVICE_NAMES` wherever a loaded module of the program
    holds them, and keeps each launch's bound seconds.  A call counts as
    a launch when the wrapper's own ``launches`` counter moves (an empty
    call launches nothing)."""

    def __init__(self):
        self.bounds: dict[str, list[float]] = collections.defaultdict(list)
        self._patched: list = []

    def _wrap(self, kernel: str, orig):
        rec = self

        def wrapper(*args, **kwargs):
            before = wrapper.launches
            out = orig(*args, **kwargs)
            if rec.active and wrapper.launches > before:
                rec.bounds[kernel].append(roofline.launch_bound(
                    kernel, args + tuple(kwargs.values())))
            return out

        wrapper.launches = getattr(orig, "launches", 0)
        wrapper.__wrapped__ = orig
        return wrapper

    def __enter__(self):
        self.active = False
        mods = [m for k, m in list(sys.modules.items())
                if m is not None and (k == PROGRAM
                                      or k.startswith(PROGRAM + "."))]
        origs = {}
        for mod in mods:
            for kernel in roofline.DEVICE_NAMES:
                fn = getattr(mod, kernel, None)
                if callable(fn) and getattr(fn, "launches", None) is not None:
                    origs.setdefault(kernel, fn)
        for kernel, orig in origs.items():
            wrapper = self._wrap(kernel, orig)
            for mod in mods:
                for attr, val in list(vars(mod).items()):
                    if val is orig:
                        setattr(mod, attr, wrapper)
                        self._patched.append((mod, attr, orig, wrapper))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig, wrapper in self._patched:
            setattr(mod, attr, orig)
            orig.launches = wrapper.launches
        self._patched = []
        return False


class Profile:
    """``torch.profiler`` over the window, reduced on exit."""

    def __init__(self, cuda: bool = True):
        import torch

        self._torch = torch
        self._cuda = cuda
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=acts, record_shapes=False, profile_memory=False,
            with_stack=False)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import time

        if self._cuda:
            self._torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._prof.__exit__(*exc)
        t1 = time.perf_counter()
        if exc[0] is None:
            self.reduce(_events(self._prof))
        #: seconds to stop the profiler and to reduce its events
        self.cost_s = (t1 - t0, time.perf_counter() - t1)
        return False

    def reduce(self, events) -> None:
        """``events``: (on_device, is_annotation, name, start_ns, end_ns)."""
        host, dev_ann = [], []
        t_by = collections.defaultdict(int)
        n_by = collections.defaultdict(int)
        starts, ends = [], []
        for on_dev, ann, name, s, e in events:
            if not on_dev:
                host.append((name, s, e))
            elif ann:
                dev_ann.append((name, s, e))
            else:
                t_by[name] += e - s
                n_by[name] += 1
                starts.append(s)
                ends.append(e)
        # the device copies of host annotations mark ranges, not work
        names = {h[0] for h in host}
        for name, s, e in dev_ann:
            if name not in names:
                t_by[name] += e - s
                n_by[name] += 1
                starts.append(s)
                ends.append(e)
        win = [h for h in host if h[0] == WINDOW_SPAN]
        if not win:
            raise RuntimeError("the trace holds no window span")
        w0, w1 = win[0][1], win[0][2]
        spans = collections.defaultdict(list)
        for name, s, e in host:
            spans[name].append((e - s) * 1e-9)
        self.spans = {k: np.asarray(v) for k, v in spans.items()}
        self.window_s = (w1 - w0) * 1e-9
        self.device_time = {k: v * 1e-9 for k, v in t_by.items()}
        self.device_count = dict(n_by)
        iv = np.stack([np.asarray(starts, np.int64),
                       np.asarray(ends, np.int64)], axis=1).reshape(-1, 2)
        iv = np.clip(iv, w0, w1)
        merged = _union(iv[iv[:, 1] > iv[:, 0]])
        self.busy_s = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-9
        edges = np.concatenate([[w0], merged.ravel(), [w1]]).reshape(-1, 2)
        gaps = [(int(a), int(b)) for a, b in edges if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        self.idle_gaps = [[_innermost(host, a), (b - a) * 1e-9]
                          for a, b in gaps[:10]]
        top = sorted(self.device_time.items(), key=lambda kv: -kv[1])[:10]
        self.device_ops = [[k, v] for k, v in top]

    def kernel_seconds(self, kernel: str) -> tuple[float, int]:
        """Device seconds and launches of a program kernel's symbols."""
        want = roofline.DEVICE_NAMES[kernel]
        t = n = 0
        for name, sec in self.device_time.items():
            if any(roofline.is_symbol(name, w) for w in want):
                t += sec
                n += self.device_count[name]
        return t, n


def _union(iv: np.ndarray) -> np.ndarray:
    """The union of [start, end) intervals, as sorted disjoint rows."""
    if iv.shape[0] == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(iv.shape[0], bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.append(np.nonzero(new)[0][1:] - 1, iv.shape[0] - 1)
    return np.stack([starts, ends[last]], axis=1)


def _innermost(host: list, t: int) -> str:
    """The host span open at ``t`` that opened last."""
    best, best_s = "none", None
    for name, s, e in host:
        if s <= t < e and (best_s is None or s >= best_s):
            best, best_s = name, s
    return best


def _events(prof):
    """(on_device, is_annotation, name, start_ns, end_ns) of every device
    event and every host annotation (host operators are skipped unread)."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            s = ev.start_ns()
            yield True, ev.is_user_annotation(), ev.name(), s, s + ev.duration_ns()
        elif ev.is_user_annotation():
            s = ev.start_ns()
            yield False, True, ev.name(), s, s + ev.duration_ns()


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own, around a call into the program."""
    import torch

    with torch.profiler.record_function(name):
        yield
