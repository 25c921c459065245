"""io of the PyTorch port (counterpart of cerebro_tpu.io)."""

from cerebro_tpu_torch.io.state import load_pipeline_state, save_pipeline_state  # noqa: F401
