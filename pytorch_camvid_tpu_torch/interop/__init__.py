"""interop of the PyTorch port (mirrors pytorch_camvid_tpu/interop)."""
