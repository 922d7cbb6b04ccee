"""Faults of the Mamba-2 path planted underneath a run, for the output
check's own tests and for the readings that set the limits of the cells
of ``systems/tmsn_sgd_hybrid.py``; importing this file adds them, with
the SGD and MoE faults (``faults.py``, ``faults_moe.py``), to
``faults.FAULTS`` under that system's name. Each patches one function of
the program and puts it back. The benchmark's runs never import this
file.

    python3 -c "import sys; sys.path.insert(0, 'bench'); import faults_hybrid, readings; \\
        sys.exit(readings.main(sys.argv[1:]))" --workload <cell> --seeds 1,2 --fault ssm_one_group
"""

from __future__ import annotations

import dataclasses

import faults
import faults_moe
from faults import _patched


def ssm_one_group():
    """Every head reads B and C of one group, the first (the other groups'
    channels unread), as a single-group Mamba-2 would."""
    from repro_torch.models import ssm

    scan = ssm.ssd_scan

    def one(xs, dt, B, C, params, Q):
        return scan(xs, dt, B[..., :1, :], C[..., :1, :], params, Q)

    return _patched(ssm, "ssd_scan", one)


def ssm_norm_whole():
    """The gated norm over all of d_inner, not over its groups."""
    from repro_torch.models import ssm

    norm = ssm._gated_norm
    return _patched(ssm, "_gated_norm",
                    lambda y, z, scale, cfg: norm(y, z, scale, dataclasses.replace(cfg, ssm_groups=1)))


def ssm_no_skip():
    """The D skip left out of the scan's output."""
    from repro_torch.models import ssm

    scan = ssm.ssd_scan

    def no_skip(xs, dt, B, C, params, Q):
        return scan(xs, dt, B, C, {**params, "D": params["D"] * 0.0}, Q)

    return _patched(ssm, "ssd_scan", no_skip)


SSM_FAULTS = {"ssm_one_group": ssm_one_group, "ssm_norm_whole": ssm_norm_whole, "ssm_no_skip": ssm_no_skip}

faults.FAULTS.setdefault("tmsn_sgd_hybrid",
                         {**faults.FAULTS["tmsn_sgd"], **faults_moe.MOE_FAULTS, **SSM_FAULTS})
