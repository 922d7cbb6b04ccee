"""Sparrow boosting: stumps, sampler, the batched scanner and the
batched worker."""
