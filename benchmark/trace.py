"""The traced window: ``torch.profiler`` over a run of steps, and what the
per-layer readers take from it.

A window whose events differ from every earlier window's (the profiler
drops a window's events now and then on the H100 machines) is taken
again; a window counts once a second one caught the same number of launches
of every kernel. Where none of ``MAX_WINDOWS`` agree, the one that caught
the most launches counts, and standard error says so.

Kernel classes, by name: the port's own kernels carry its ``gasfm::``
namespace; the optimizer's are Adam's and the multi-tensor kernels other
than the gradient norm's; every other kernel is PyTorch's (GEMMs,
LayerNorms, reductions, elementwise work).
"""

from __future__ import annotations

import collections
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

MAX_WINDOWS = 8


def is_port_kernel(name: str) -> bool:
    return "gasfm::" in name


def is_optimizer_kernel(name: str) -> bool:
    return "adam" in name.lower() or ("multi_tensor_apply" in name and "LpNorm" not in name)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Window:
    """One window of ``steps`` steps, ``wall_s`` long on the host's clock,
    and the profiler's ``events`` of it."""

    def __init__(self, steps: int, wall_s: float, events=()):
        from torch.autograd import DeviceType

        self.steps, self.window_s = steps, wall_s
        self.kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
        device, host = [], []
        for evt in events:
            if getattr(evt, "is_user_annotation", False):
                continue  # ranges over the kernels they enclose
            a, b = evt.time_range.start * 1e-6, evt.time_range.end * 1e-6
            if evt.device_type == DeviceType.CUDA:
                device.append((a, b))
                if not evt.name.startswith(("Memcpy", "Memset")):
                    k = self.kernels[evt.name]
                    k[0] += 1
                    k[1] += b - a
            else:
                host.append((a, b, evt.name))
        self.busy = _merge(device)
        self.busy_s = sum(b - a for a, b in self.busy)
        # the device's own time line: its first operation's start to its last one's end
        self.span_s = self.busy[-1][1] - self.busy[0][0] if self.busy else 0.0
        self.host = host

    def counts(self) -> Dict[str, int]:
        return {k: v[0] for k, v in self.kernels.items()}

    def seconds(self, keep: Callable[[str], bool]) -> float:
        return sum(t for name, (_, t) in self.kernels.items() if keep(name))

    def launches(self) -> int:
        return sum(c for c, _ in self.kernels.values())

    def breakdown(self) -> dict:
        ops = sorted(((n, t) for n, (_, t) in self.kernels.items()), key=lambda x: -x[1])[:10]
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(self.busy, self.busy[1:]) if a1 > b0]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:10]:
            mid = (a + b) / 2
            inside = [(s, n) for s, e, n in self.host if s <= mid <= e]
            named.append([f"host: {max(inside)[1]}" if inside else "host: untraced", b - a])
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


def traced_window(step: Callable[[], object], steps: int, sync: Callable[[], None]
                  ) -> Optional[Window]:
    """Windows of ``steps`` steps until one agrees with an earlier one; if
    none do, the one that caught the most launches (the profiler drops
    events, it adds none); None if no window caught a launch."""
    from torch.profiler import ProfilerActivity, profile

    taken: List[Window] = []
    for _ in range(MAX_WINDOWS):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            sync()
            wall = time.perf_counter() - t0
        win = Window(steps, wall, prof.events())
        _report(win, taken[-1] if taken else None)
        if win.launches() == 0:
            continue
        if any(win.counts() == earlier.counts() for earlier in taken):
            return win
        taken.append(win)
    if not taken:
        return None
    best = max(taken, key=Window.launches)
    print(f"traced window: no two of {MAX_WINDOWS} agreed; the one of {best.launches()} "
          f"launches is read", file=sys.stderr)
    return best


def _report(win: Window, prev: Optional[Window]) -> None:
    """One line on standard error for each traced window: its launches and
    the kernels whose launches differ from the previous window's."""
    differ = []
    if prev is not None:
        a, b = prev.counts(), win.counts()
        differ = sorted((n, a.get(n, 0), b.get(n, 0)) for n in set(a) | set(b)
                        if a.get(n, 0) != b.get(n, 0))
    print(f"traced window: {win.steps} steps, {win.launches()} launches, "
          f"{win.window_s:.4f} s, {len(differ)} kernels differ {differ[:4]}"[:600],
          file=sys.stderr)


def device_synchronize(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None
