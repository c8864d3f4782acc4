"""Device meshes, the train step and launchers of the port (port of
``repro.launch``: the mesh builders, ``train.py``, and ``serve.py``, run
as ``python -m repro_torch.launch.serve``)."""
from .mesh import SweepMesh, dp_axes, dp_size, make_sweep_mesh, make_test_mesh
from .train import choose_accum, make_eval_step, make_train_step

__all__ = ["SweepMesh", "choose_accum", "dp_axes", "dp_size",
           "make_eval_step", "make_sweep_mesh", "make_test_mesh",
           "make_train_step"]
