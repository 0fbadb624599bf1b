"""Launch tooling of the port (counterpart of ``repro.launch``): the
data-parallel process group the distributed engine runs on and the named
device mesh of the LM substrate (``launch.mesh``, with a fake world for
the dry run), the LM trainer (``launch.train``, run as ``python -m
repro_torch.launch.train``), the dry run (``launch.dryrun``,
``launch.step_stats``) and its roofline and tables (``launch.roofline``,
``launch.report``)."""
from .mesh import make_compat_mesh, make_data_group

__all__ = ["make_compat_mesh", "make_data_group"]
