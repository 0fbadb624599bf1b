"""Launch tooling of the port (counterpart of ``repro.launch``): so far the
data-parallel process group the distributed engine runs on."""
from .mesh import make_data_group

__all__ = ["make_data_group"]
