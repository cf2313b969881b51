"""Measurement scripts for the card: per-shape kernel comparisons between two
trees (``compare_conv``), source variants of the conv kernel
(``conv_variants``) and device-time profiles of the serving tile batch and
the train step (``profile_chip``). They import torch only when run."""
