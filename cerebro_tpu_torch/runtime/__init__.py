"""runtime of the PyTorch port (counterpart of cerebro_tpu.runtime)."""
