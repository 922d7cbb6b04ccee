"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their
wrappers (:mod:`.ops`) and their plain PyTorch versions (:mod:`.ref`).
The library is built with ``nvcc`` at first use (:mod:`.build`), never
at import. :func:`scatter_model_slice` prepares kernel K4's operands
from a model slice."""

from repro_torch.kernels import ops
from repro_torch.kernels.weight_update import scatter_model_slice

__all__ = ["ops", "scatter_model_slice"]
