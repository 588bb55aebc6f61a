"""Host-side scenes: the numpy SceneData subset and the synthetic generator."""
