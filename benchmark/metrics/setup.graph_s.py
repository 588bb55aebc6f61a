"""Seconds of the scene's graph: the port's first ``scene_graph`` call, the
host build and the upload."""


def read(r):
    return r.spans.get("graph")
