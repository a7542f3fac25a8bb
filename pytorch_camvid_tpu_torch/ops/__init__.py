"""ops of the PyTorch port (mirrors pytorch_camvid_tpu/ops)."""
