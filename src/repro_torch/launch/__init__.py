"""Device meshes and launchers of the port (port of ``repro.launch``: the mesh
builders, and ``serve.py``, run as ``python -m repro_torch.launch.serve``)."""
from .mesh import SweepMesh, dp_axes, dp_size, make_sweep_mesh, make_test_mesh

__all__ = ["SweepMesh", "dp_axes", "dp_size", "make_sweep_mesh",
           "make_test_mesh"]
