"""sage2_tpu_torch — the sage2_tpu assembler ported to PyTorch and CUDA.

The same method as sage2_tpu (overlap-graph assembly of short reads:
exact k-mer counting, spectrum error correction, exact suffix-prefix
overlaps, string-graph reduction, coverage-cost traversal), written in
PyTorch for one NVIDIA Hopper GPU, with hand-written CUDA kernels for
the hot device programs (``sage2_tpu_torch.kernels``). The JAX package
``sage2_tpu`` is the reference: each stage gives its outputs bit for bit.

This package imports torch, numpy and the standard library only. Entry
points run on ``device="cuda"`` unless the caller asks for
``device="cpu"``, where the kernels' plain PyTorch versions run.
"""

from sage2_tpu_torch.config import AssemblyConfig

__version__ = "0.1.0"

__all__ = ["AssemblyConfig", "__version__"]
