"""Host-side rendering of object meshes (BGR uint8 + eye-space z depth
float32), the synthetic depth that ICP and depth re-scoring compare with
the observed frame:

  * `Renderer` -- facade over the C++ rasterizer (native/) or the numpy
    reference rasterizer (raster_numpy.py)
  * `load_mesh` -- PLY / OBJ loading (mesh.py)
"""

from .facade import Renderer
from .mesh import Mesh, load_mesh

__all__ = ["Renderer", "Mesh", "load_mesh"]
