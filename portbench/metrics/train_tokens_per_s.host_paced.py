"""Tokens trained in the window's whole steps over the window's seconds
(host clock, the device synchronised at both edges), read per layer in the
cells whose step the shared host paces: there the rate's runs spread too
widely for any bound, so it guards nothing end to end and is kept as a
reading."""


def read(m):
    w = m["window"]
    return w["tokens"] / w["seconds"]
