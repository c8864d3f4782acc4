"""Device seconds of pageable host-to-device copies a million requests of each schedule built."""
from perfbench import readers


def read(ctx):
    return readers.pageable_upload_s_per_mreq(ctx, per_schedule=True)
