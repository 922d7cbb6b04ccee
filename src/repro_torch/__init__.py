"""PyTorch port of the TMSN reproduction, for an NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (the reference it is
tested against) and imports nothing of it: ``core/`` (protocol, stopping
rule, ESS, worker contract, results, the round engine), ``boosting/``
(stumps, sampler, scanner, batched Sparrow), ``data/``, ``configs/`` and
``kernels/`` (hand-written CUDA kernels for Hopper, their wrappers and
their plain PyTorch versions). :mod:`repro_torch.convert` moves state
between the two packages.
"""
