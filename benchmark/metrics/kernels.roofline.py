"""The port's kernels against their roofline: the summed least time of the
step's launches (``benchmark.counts``, ``benchmark.roofline``) over the
device time per step of the port's kernels, matched by kernel name. Where
a traced kernel of the port has no count, or launches another number of
times per step than counted, nothing is read: the counts no longer
describe the step."""

import collections
import sys

from benchmark.counts import base_name
from benchmark.roofline import bound_s
from benchmark.trace import is_port_kernel


def read(r):
    w = r.window
    if w is None or not r.kernel_launches:
        return None
    counted = collections.defaultdict(list)
    for name, nbytes, flops in r.kernel_launches:
        counted[name].append(bound_s(nbytes, flops))
    traced = collections.defaultdict(lambda: [0, 0.0])
    for kernel, (launches, seconds) in w.kernels.items():
        if is_port_kernel(kernel):
            t = traced[base_name(kernel)]
            t[0] += launches
            t[1] += seconds
    if not traced:
        return None
    per_step = {k: v[0] / w.steps for k, v in traced.items()}
    want = {k: len(v) for k, v in counted.items()}
    if per_step != want:
        print(f"kernels.roofline: launches per step traced {sorted(per_step.items())}, "
              f"counted {sorted(want.items())}", file=sys.stderr)
        return None
    bound = sum(sum(v) for v in counted.values())
    return 100.0 * bound / (sum(t for _, t in traced.values()) / w.steps)
