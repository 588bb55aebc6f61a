"""Segment reductions, GATv2 attention and the hand-written kernels."""
