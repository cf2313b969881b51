"""The data pipeline the port's CLIs read: NIfTI IO, supervision masks, the
AMOS dataset with its atlas channel and intensity augmentation. Copies of
the JAX package's JAX-free ``multimodal_pl_tpu/data`` modules (importing
those would run the JAX package's ``__init__``), pinned to them by
``tests/test_torch_port_data.py``."""
