"""Data generators and host streaming of the port (numpy copies of
``repro.data``, plus the torch staging of ``data.stream``)."""
from .synthetic import (drop_pixels, flight_like, oilflow_like,
                        sines_dataset, usps_like)

__all__ = ["drop_pixels", "flight_like", "oilflow_like", "sines_dataset",
           "usps_like"]
