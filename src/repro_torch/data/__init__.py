"""Data generators and host streaming of the port (numpy copies of
``repro.data``, plus the torch staging of ``data.stream``), and the LM
token stream (``data.tokens``)."""
from .synthetic import (drop_pixels, flight_like, oilflow_like,
                        sines_dataset, usps_like)
from .tokens import TokenStream, zipf_logits

__all__ = ["drop_pixels", "flight_like", "oilflow_like", "sines_dataset",
           "usps_like", "TokenStream", "zipf_logits"]
