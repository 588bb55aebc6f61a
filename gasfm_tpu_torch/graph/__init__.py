"""The port's view graph (point and camera CSR over the valid edges)."""
