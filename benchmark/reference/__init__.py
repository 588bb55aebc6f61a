"""The plain reference: GASFM, DPESFM, the ESFM loss, our_repro and Adam in
plain PyTorch, float32, with no kernel, cache or batching.

It imports nothing of the program under test and re-derives the scene's
graph from the measurement matrix itself (:mod:`benchmark.reference.graph`).
Parameter names follow the published PyTorch models' ``state_dict`` (the
names the program keeps too), so one set of weights made by the benchmark
loads into both sides.
"""
