"""Kernel inputs captured from a replay, to hold each kernel against its
plain version at the shapes the replay itself gives it.

Off unless a caller sets :data:`INPUTS` to a dict (``chip_smoke.py`` does,
around one replay).  Then the kernels' call sites on the host-schedule
path keep their largest inputs in it, by kernel name: the widest scan
step's values and start flags, the largest lookup's table and ids, and
the largest incidence ``H`` and membership/CRM pair ``M``, ``A`` of the
host clique generation.  When off, a call site pays one ``is None`` test.
"""
from __future__ import annotations

#: kernel name -> (size, tuple of input copies); None = capture off
INPUTS: dict | None = None


def keep_largest(name: str, size: int, make) -> None:
    """Record ``make()`` (a tuple of copies) under ``name`` if ``size``
    beats what is kept there."""
    if INPUTS is None:
        return
    cur = INPUTS.get(name)
    if cur is None or size > cur[0]:
        INPUTS[name] = (int(size), make())
