"""Graph-validity constants (the JAX package's utils/constants.py, copied)."""

# A point visible in fewer than this many views is discarded.
MIN_N_VIEWS_PER_POINT = 2

# A scene (or sampled sub-scene) is invalid if any view has fewer visible
# points than this.
MIN_N_POINTS_PER_VIEW = 8
