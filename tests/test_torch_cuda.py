"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K1 ``edge_scan`` to 1e-5 and bitwise equal to itself on a second
launch (no float atomics), K2 ``round_step`` and K3 ``queue_ingest``
bit-exact, K4 ``weight_update`` to rtol 1e-4 / atol 1e-5 (the
reference's own tolerance) and bitwise equal to itself. Imports no JAX,
so it runs on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test needs a CUDA device (marker ``cuda``) and skips without one.
The inputs are the ones tests/test_torch_kernels.py holds the plain
versions to against the JAX reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _scan_inputs(seed, w, n, d, num_bins):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, num_bins, (w, n, d), dtype=np.int32)
    wt = (rng.random((w, n)) + 0.05).astype(np.float32)
    y = np.where(rng.random((w, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    return xb, (wt * y).astype(np.float32), wt


def _round_inputs(seed, w, cap, fill=0.6):
    rng = np.random.default_rng(seed)
    q_cert = np.where(
        rng.random((w, cap)) < fill, -rng.random((w, cap)) - 0.01, np.inf
    ).astype(np.float32)
    q_due = rng.integers(0, 4, (w, cap), dtype=np.int32)
    q_src = rng.integers(0, w, (w, cap), dtype=np.int32)
    q_slot = rng.integers(0, 3, (w, cap), dtype=np.int32)
    certs0 = (-rng.random(w)).astype(np.float32)
    alive = rng.random(w) < 0.8
    credit = rng.random(w).astype(np.float32)
    speed = np.linspace(0.2, 1.0, w).astype(np.float32)
    return q_cert, q_due, q_src, q_slot, certs0, alive, credit, speed


def _ingest_inputs(seed, w, cap, m, fill=0.6):
    rng = np.random.default_rng(seed)

    def certs(shape):
        return np.where(rng.random(shape) < fill, -rng.random(shape) - 0.01, np.inf).astype(np.float32)

    return (
        certs((w, cap)),
        rng.integers(0, 6, (w, cap), dtype=np.int32),
        rng.integers(0, w, (w, cap), dtype=np.int32),
        rng.integers(0, 3, (w, cap), dtype=np.int32),
        certs((w, m)),
        rng.integers(0, 6, (w, m), dtype=np.int32),
        rng.integers(0, w, (w, m), dtype=np.int32),
        rng.integers(0, 3, (w, m), dtype=np.int32),
    )




@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _cuda(arrays, dev):
    return [_t(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("w,n,d,num_bins", [(10, 2048, 64, 8), (3, 100, 33, 5), (2, 7, 4, 16)])
def test_cuda_edge_scan(cuda_device, w, n, d, num_bins):
    args = _cuda(_scan_inputs(w + n, w, n, d, num_bins), cuda_device)
    got = tops.edge_scan(*args, num_bins=num_bins)
    again = tops.edge_scan(*args, num_bins=num_bins)
    plain = tref.edge_scan_ref(*args, num_bins)
    for a, b, c in zip(got, again, plain):
        assert torch.equal(a, b)  # deterministic: no float atomics
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("w,cap", [(10, 64), (4096, 64), (7, 5)])
def test_cuda_round_step(cuda_device, w, cap):
    args = _cuda(_round_inputs(w, w, cap), cuda_device)
    for r in (0, 2):
        got = tops.round_deliver(*args, r, eps=0.01)
        plain = tref.round_step_ref(*args, r, eps=0.01)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("w,cap,m", [(10, 64, 1), (4096, 64, 8), (7, 4, 3)])
def test_cuda_queue_ingest(cuda_device, w, cap, m):
    args = _cuda(_ingest_inputs(w + m, w, cap, m), cuda_device)
    got = tops.queue_ingest(*args)
    plain = tref.queue_ingest_ref(*args)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def _weight_inputs(seed, n, d, num_bins):
    """Bins that also fall outside [0, B), margins, and (A, c) from
    ``scatter_model_slice`` of a random 256-stump model."""
    from repro_torch.boosting.stumps import StumpModel

    rng = np.random.default_rng(seed)
    xb = rng.integers(-1, num_bins + 1, (n, d), dtype=np.int32)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    ml = (rng.standard_normal(n) * 0.5).astype(np.float32)
    ms = (rng.standard_normal(n) * 0.5).astype(np.float32)
    t = 256
    model = StumpModel(
        feat=_t(rng.integers(0, d, t, dtype=np.int32)),
        thr=_t(rng.integers(0, num_bins - 1, t, dtype=np.int32)),
        sign=_t(np.where(rng.random(t) < 0.5, 1.0, -1.0).astype(np.float32)),
        alpha=_t(rng.uniform(0.01, 0.3, t).astype(np.float32)),
        count=torch.tensor(t, dtype=torch.int32),
    )
    return xb, y, ml, ms, model


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,num_bins", [(180_000, 64, 8), (777, 16, 32), (5, 8, 8)])
def test_cuda_weight_update(cuda_device, n, d, num_bins):
    from repro_torch.kernels import scatter_model_slice

    xb, y, ml, ms, model = _weight_inputs(n + d, n, d, num_bins)
    model = type(model)(*(f.to(cuda_device) for f in model))
    a, c = scatter_model_slice(model, 0, 256, num_bins, d)
    a2, c2 = scatter_model_slice(model, 0, 256, num_bins, d)
    assert torch.equal(a, a2) and torch.equal(c, c2)  # no float atomics in the scatter
    args = _cuda((xb, y, ml, ms), cuda_device)
    got = tops.weight_update(*args, a, c, num_bins=num_bins)
    again = tops.weight_update(*args, a, c, num_bins=num_bins)
    plain = tref.weight_update_ref(*args, a, c, num_bins)
    for g, b, p in zip(got, again, plain):
        assert torch.equal(g, b)  # deterministic
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)
    # c as a Python float takes the same path
    m_f, _ = tops.weight_update(*args, a, float(c), num_bins=num_bins)
    torch.testing.assert_close(m_f, plain[0], rtol=1e-4, atol=1e-5)
