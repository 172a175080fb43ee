"""PyTorch/CUDA port of the serving stack of ``runbookai_tpu``.

The JAX package stays the reference; this package keeps its module names
(``models/llama.py``, ``engine/engine.py``, ...) and runs on one NVIDIA GPU,
with hand-written CUDA kernels in ``csrc/`` for the paged attention that the
JAX package wrote in Pallas. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where every kernel runs its plain PyTorch version.
"""
