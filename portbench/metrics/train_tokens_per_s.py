"""Tokens trained in the window's whole steps over the window's seconds
(host clock, the device synchronised at both edges)."""


def read(m):
    w = m["window"]
    return w["tokens"] / w["seconds"]
