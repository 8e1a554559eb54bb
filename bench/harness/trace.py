"""The device trace of a ``--trace 1`` run.

``DeviceTrace`` runs ``torch.profiler`` over the measured window and
brackets the window in a ``bench.window`` annotation.  The CUDA kernels of
the port are launched through ``ctypes``, not through an aten op, so the
profiler cannot name the op that launched them; the port exposes each call
through ``CudaKernel.observers`` (called after a call that launched), and
the trace uses that to bracket every op call in an annotation of its own:
a ``bench.op.<i>`` scope is open from the previous call's return to call
i's return.  A kernel whose launch (the CUDA runtime call that CUPTI
correlates it with) ran inside scope i and outside every host op (an aten
op launches its own kernels) is call i's.

``summary()`` reduces the trace to what the metric readers take:
the traced window, the seconds in which the device ran an operation
(kernels, copies, sets; their union), each op call with its shapes and the
device seconds of its kernels, the device operations that took most time,
and the device's idle gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"
SCOPE = "bench.op."
TOP = 10
NAME_CHARS = 160


@dataclass
class OpCall:
    op: str            # CudaKernel.name
    shapes: list       # shapes of the tensor arguments, in order
    itemsize: int      # bytes of an element of the first argument
    device_s: float = 0.0
    kernels: int = 0   # device kernels linked to the call


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    calls: list = field(default_factory=list)        # [OpCall]
    device_ops: list = field(default_factory=list)   # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)    # [[host op, seconds]]


class DeviceTrace:
    """Context manager over the measured window (see module docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.calls: list[OpCall] = []
        self._scope = None
        self._window = None
        self._prof = None

    # -- op scopes ----------------------------------------------------------
    def _open_scope(self):
        self._scope = torch.profiler.record_function(
            f"{SCOPE}{len(self.calls)}")
        self._scope.__enter__()

    def _close_scope(self):
        if self._scope is not None:
            self._scope.__exit__(None, None, None)
            self._scope = None

    def _observe(self, kern, args, kwargs, out):
        self._close_scope()
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        self.calls.append(OpCall(kern.name, [tuple(a.shape) for a in tensors],
                                 tensors[0].element_size() if tensors else 4))
        self._open_scope()

    # -- lifetime -----------------------------------------------------------
    def __enter__(self):
        from repro_torch.kernels._build import CudaKernel
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        CudaKernel.observers.append(self._observe)
        self._open_scope()
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels._build import CudaKernel
        CudaKernel.observers.remove(self._observe)
        self._close_scope()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        return False

    # -- reduction ----------------------------------------------------------
    def summary(self) -> TraceSummary:
        from torch.autograd import DeviceType
        win = None
        scopes, host, dev = [], [], []
        launches = {}        # CUPTI correlation -> (host time, thread)
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CPU:
                span = (e.start_ns(), e.end_ns())
                if e.is_user_annotation() and name == WINDOW:
                    win = (*span, e.start_thread_id())
                elif e.is_user_annotation() and name.startswith(SCOPE):
                    scopes.append((*span, int(name[len(SCOPE):])))
                elif _runtime(name):
                    launches[e.correlation_id()] = (span[0],
                                                    e.start_thread_id())
                else:
                    host.append((*span, name, e.start_thread_id()))
            elif not e.is_user_annotation():   # kernels, copies, sets
                dev.append((e.start_ns(), e.end_ns(), name,
                            e.linked_correlation_id() or e.correlation_id()))
        if win is None:
            raise RuntimeError("the profiler recorded no bench.window span")
        w0, w1, main_tid = win
        by_tid = defaultdict(list)
        for s0, s1, name, tid in host:
            by_tid[tid].append((s0, s1, name))
        for ops in by_tid.values():
            ops.sort()
        self._link(dev, launches, sorted(scopes), by_tid)
        busy = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in dev
                       if e > w0 and s < w1])
        by_name = defaultdict(float)
        for s, e, name, _ in dev:
            by_name[name[:NAME_CHARS]] += (e - s) * 1e-9
        return TraceSummary(
            window_s=(w1 - w0) * 1e-9,
            busy_s=sum(e - s for s, e in busy) * 1e-9,
            calls=self.calls,
            device_ops=_top(by_name),
            idle_gaps=_top(_label_gaps(_gaps(busy, w0, w1),
                                       by_tid.get(main_tid, []))),
        )

    def _link(self, dev, launches, scopes, by_tid) -> None:
        """Device kernels to op calls: a kernel whose launch (the runtime
        call CUPTI correlates it with) ran inside scope i and inside no
        host op is call i's."""
        starts = [s[0] for s in scopes]
        for s0, s1, _, corr in dev:
            at = launches.get(corr)
            if at is None:
                continue
            t, tid = at
            i = bisect.bisect_right(starts, t) - 1
            if i < 0 or scopes[i][1] < t or _innermost(by_tid[tid], t):
                continue
            j = scopes[i][2]
            if j < len(self.calls):
                self.calls[j].device_s += (s1 - s0) * 1e-9
                self.calls[j].kernels += 1


def _runtime(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel...):
    the host op around it says more of what the host was doing."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _union(iv: list) -> list:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _gaps(busy: list, w0: int, w1: int) -> list:
    edges = [w0] + [x for b in busy for x in b] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _innermost(ops: list, t: int):
    """The name of the innermost of ``ops`` (sorted (start, end, name))
    running at ``t``, or None: it starts last among those that contain t,
    and ops nest, so a walk back past a few siblings finds it."""
    i = bisect.bisect_right(ops, (t, float("inf"), ""))
    for _, e, n in reversed(ops[max(0, i - 64):i]):
        if e >= t:
            return n
    return None


def _label_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by the innermost host op running at each gap's middle
    (``python`` where no op ran: the interpreter between ops)."""
    out = defaultdict(float)
    for g0, g1 in gaps:
        label = _innermost(host, (g0 + g1) // 2) or "python"
        out[label[:NAME_CHARS]] += (g1 - g0) * 1e-9
    return out


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
