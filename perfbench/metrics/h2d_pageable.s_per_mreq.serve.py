"""Device seconds of pageable host-to-device copies a million requests served."""
from perfbench import readers


def read(ctx):
    return readers.pageable_upload_s_per_mreq(ctx)
