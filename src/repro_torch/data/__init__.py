"""Data generators of the port (numpy copies of ``repro.data``)."""
from .synthetic import drop_pixels, sines_dataset, usps_like

__all__ = ["drop_pixels", "sines_dataset", "usps_like"]
