"""The scatter-reduce's host seconds a step: the mean over the window's steps
of the slowest worker's time in ``local_scatter_reduce``, waits included
(the ``sync`` of each step's ``StepTiming``).  Nothing to read with one
replica."""


def read(m):
    if m["replicas"] < 2 or not m["syncs"]:
        return None
    return sum(m["syncs"]) / len(m["syncs"])
