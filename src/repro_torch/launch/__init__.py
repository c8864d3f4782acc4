"""Device meshes, sharding rules, the train step, the dry run and
launchers of the port (port of ``repro.launch``: the mesh builders,
``sharding.py``, ``specs.py``, ``train.py``, ``dryrun.py`` with
``cost_analysis.py`` in place of ``hlo_analysis.py``, and ``serve.py``,
run as ``python -m repro_torch.launch.serve`` / ``.dryrun``)."""
from .mesh import (
    SweepMesh,
    dp_axes,
    dp_size,
    make_production_mesh,
    make_sweep_mesh,
    make_test_mesh,
)
from .train import choose_accum, make_eval_step, make_train_step

__all__ = ["SweepMesh", "choose_accum", "dp_axes", "dp_size",
           "make_eval_step", "make_production_mesh", "make_sweep_mesh",
           "make_test_mesh", "make_train_step"]
