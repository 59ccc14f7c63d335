"""pool_build_s (host clock): ``Session.offline`` for one call's triples
over the cell's streams, ended by a synchronize, in set-up."""


def read(rec):
    return rec["pool_build_s"]
