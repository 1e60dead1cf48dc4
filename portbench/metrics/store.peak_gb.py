"""The object store's peak of live bytes over the run (``StoreStats.peak_bytes``
of the ``local`` backend's ``LocalStore``: activations, gradients and
scatter-reduce chunks in flight), in GB."""


def read(m):
    return m["store"]["peak_bytes"] / 1e9
