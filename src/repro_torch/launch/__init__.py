"""Device meshes of the port (port of ``repro.launch``'s mesh builders)."""
from .mesh import SweepMesh, dp_axes, dp_size, make_sweep_mesh, make_test_mesh

__all__ = ["SweepMesh", "dp_axes", "dp_size", "make_sweep_mesh",
           "make_test_mesh"]
