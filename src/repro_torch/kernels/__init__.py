"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their
wrappers (:mod:`.ops`) and their plain PyTorch versions (:mod:`.ref`).
The library is built with ``nvcc`` at first use (:mod:`.build`), never
at import."""
