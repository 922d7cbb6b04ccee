"""Launch side of the port; counterpart of ``src/repro/launch``:
``steps`` (step factories and input specs), ``serving`` (the adoption
slot and the continuous-batching server), ``serve`` (the batched entry
point and its CLI), ``mesh`` (the production meshes and the workers
mesh), ``sharding`` (the spec rules and their DTensor placements),
``train`` (the training entry point), ``analytic``, ``hlo_analysis`` and
``dryrun`` (the per-device memory, roofline and collective plan of every
architecture on the production meshes)."""
