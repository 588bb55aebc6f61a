"""Geometry helpers: host-side numpy (np_geo) and torch (rotations)."""
