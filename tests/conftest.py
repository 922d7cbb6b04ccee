"""The test tier's CPU threading, set once for every test process.

The tier runs in several test processes at once, and they share the
host's cores. At torch's default of one intra-op thread per core, each
process starts a full OpenMP pool, and the pools' workers spin while
they wait. On an 8-core host, a case that takes 8.65 s alone took 437 s
with six copies running at once. So each test process runs torch at one
intra-op thread. That is also what ``repro_torch.launch.mesh.spawn_world``
gives each rank, so a single-process run reduces in the ranks' order.
No test sets threads of its own. Where torch is absent this does
nothing, and the port's files skip at their ``importorskip``.
"""

try:
    import torch
except ImportError:
    pass
else:
    torch.set_num_threads(1)
