"""Graph-validity constants (the JAX package's utils/constants.py, copied)."""

# A point visible in fewer than this many views is discarded.
MIN_N_VIEWS_PER_POINT = 2

# A scene (or sampled sub-scene) is invalid if any view has fewer visible
# points than this.
MIN_N_POINTS_PER_VIEW = 8

# The most cameras a scene may have for the merged GASFM path and the dual
# attention kernel: the JAX package's _DENSE_MAX_SEGMENTS
# (gasfm_tpu/ops/segment.py:62), whose model code gates its packed layout,
# fused frontend, dual attention and edge-combine kernel on it. Above it
# every GASFM layer runs unfused (models/gasfm.py).
DENSE_MAX_SEGMENTS = 1024
