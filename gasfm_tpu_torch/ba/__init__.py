"""Bundle adjustment (native C++ on the host): Euclidean and projective
drivers, the counterpart of the JAX package's ba/ (reference
code/utils/ba_functions.py, ceres_utils.py and the Ceres cost functions):
a self-contained Levenberg-Marquardt solver with forward-mode Jacobians,
Huber loss and a dense Schur complement, driven through ctypes; and the
``.mat`` readers of scenes for comparisons with external BA pipelines
(``ba/io.py``), off the CLI's path."""

from gasfm_tpu_torch.ba.drivers import euc_ba, proj_ba
from gasfm_tpu_torch.ba.packing import order_cam_param_for_c, reorder_from_c_to_py

__all__ = ["euc_ba", "proj_ba", "order_cam_param_for_c", "reorder_from_c_to_py"]
