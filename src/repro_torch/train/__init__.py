"""Step builders of the LM substrate (port of ``repro.train.steps``)."""
