"""runtime of the PyTorch port (counterpart of cerebro_tpu.runtime).

The JAX package's ``compile_cache`` has no counterpart: eager PyTorch
compiles nothing, and the kernels' nvcc output is cached in
``cerebro_tpu_torch/_build/`` under a hash of each source."""

from cerebro_tpu_torch.runtime.pipeline import (  # noqa: F401
    CerebroPipeline,
    LoopEdge,
    StreamIngestor,
)
from cerebro_tpu_torch.runtime.service import CerebroService  # noqa: F401
