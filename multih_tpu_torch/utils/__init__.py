"""Part of the PyTorch port (see multih_tpu_torch/__init__.py)."""
