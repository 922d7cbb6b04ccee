"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
repository root. The card-only tests carry the ``cuda`` marker and decide
inside the test whether a card is there."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import run  # noqa: E402,F401  (puts src/ on the path)

#: tiny shapes for CPU rehearsals of each system's path
TINY = {
    "tmsn_sgd": {"config": {"arch": {"name": "tiny", "arch_type": "dense", "num_layers": 1, "d_model": 64,
                                     "num_heads": 4, "num_kv_heads": 2, "d_ff": 128, "vocab": 256,
                                     "rope_theta": 10000.0, "norm_eps": 1e-5, "tie_embeddings": False,
                                     "mlp_gated": True, "param_dtype": "float32", "compute_dtype": "float32",
                                     "remat": True}},
                 "traffic": {"batch": 2, "seq": 16, "traced_rounds": 1}},
}
