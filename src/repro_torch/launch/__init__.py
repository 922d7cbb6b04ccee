"""Serving and mesh side of the port; counterpart of ``src/repro/launch``:
``steps`` (step factories and input specs), ``serving`` (the adoption
slot and the continuous-batching server), ``serve`` (the batched entry point
and its CLI) and ``mesh`` (the workers mesh)."""
