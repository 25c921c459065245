"""cerebro_tpu_torch — the PyTorch/CUDA port of cerebro_tpu for NVIDIA Hopper.

The JAX package ``cerebro_tpu`` is the reference; this package reproduces
its Method-A live loop (ported NetVLAD descriptor -> ring descriptor DB ->
masked score+argmax detection -> tier-1 stereo verification) in PyTorch,
with the two Pallas kernels on that path rewritten as CUDA C++ for
``sm_90a`` (``csrc/``). Module names follow the JAX package so each
counterpart is easy to find. Nothing here imports JAX or ``cerebro_tpu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a kernel wrapper given a CPU tensor runs its plain PyTorch
version, given a CUDA tensor it launches its kernel or raises.
"""
