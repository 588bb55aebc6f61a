"""The training session: for now its forward and loss (evaluation path)."""
