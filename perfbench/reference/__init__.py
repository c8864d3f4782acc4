"""The benchmark's plain reference: numpy only, nothing of the program.

Frozen copies of the reference package's host modules (cost model,
CRM, clique generation, batched replay) and the AKPC stream driver of
:mod:`.akpc`, which the benchmark replays over the requests a run served.
"""
