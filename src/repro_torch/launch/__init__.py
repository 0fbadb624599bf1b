"""Launch tooling of the port (counterpart of ``repro.launch``): the
data-parallel process group the distributed engine runs on and the named
device mesh of the LM substrate (``launch.mesh``), the LM trainer
(``launch.train``, run as ``python -m repro_torch.launch.train``) and the
analytic model FLOPs (``launch.roofline``)."""
from .mesh import make_compat_mesh, make_data_group

__all__ = ["make_compat_mesh", "make_data_group"]
