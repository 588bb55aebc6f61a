"""Print the CPU parity errors of the PyTorch port against the JAX package.

    JAX_PLATFORMS=cpu python tests/torch_port_parity_report.py

Runs the comparisons of tests/test_torch_port_kernels.py and
tests/test_torch_port_model.py (the JAX side's Pallas kernels in interpret
mode, the port's plain versions) and prints, per compared output, the max
absolute error and that error over the reference's max magnitude. The tests
assert the tolerances; this prints the numbers behind them.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo root
import conftest  # noqa: E402,F401  (JAX on the CPU, as under pytest)
from gasfm_tpu.ops.segment import set_kernel_mode  # noqa: E402

import test_torch_port_kernels as tk  # noqa: E402
import test_torch_port_model as tm  # noqa: E402


def report(case, pairs):
    for name, got, want in pairs:
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        print(f"{case:38s} {name:12s} max_abs_err {err:.3e}  rel_to_max {err / max(scale, 1e-30):.3e}")


def main():
    graphs = tk.make_graphs()
    set_kernel_mode("interpret")
    try:
        for D in (32, 4):
            report(f"fused_dual_attend D={D}", tk.dual_attend_pairs(graphs, D))
        for De, D in ((2, 4), (32, 32)):
            for raw in (False, True):
                report(f"fused_frontend De={De}{' raw' if raw else ''}",
                       tk.frontend_pairs(graphs, De, D, raw))
        for form in tk.LAYER_STEP_FORMS:
            report(f"fused_layer_step {form}", tk.layer_step_pairs(graphs, form))
        for hinge in (True, False):
            report(f"fused_esfm_terms hinge={hinge}", tk.esfm_terms_pairs(graphs, hinge))
    finally:
        set_kernel_mode("auto")
    for name, widths in tm.CONFIGS.items():
        jax_result = tm.run_jax(widths)
        report(f"GASFM {name} + ESFMLoss", tm.forward_pairs(jax_result, tm.run_port(jax_result)))


if __name__ == "__main__":
    main()
