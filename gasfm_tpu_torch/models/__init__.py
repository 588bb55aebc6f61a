"""The GASFM model: layers, heads, the network and weight conversion."""
