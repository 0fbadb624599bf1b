"""The LM substrate (port of ``repro.models``): GQA (with local windows),
MLA, Mamba-2 SSD and RG-LRU mixers; MLP and dense MoE FFNs; decoder-only
and enc-dec assembly."""
