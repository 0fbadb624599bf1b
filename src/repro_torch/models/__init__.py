"""The LM substrate (port of ``repro.models``): dense GQA transformers."""
