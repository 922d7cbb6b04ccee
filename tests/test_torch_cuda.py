"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K1 ``edge_scan`` to 1e-5 and bitwise equal to itself on a second
launch (no float atomics), also through ``edge_histogram``, K2
``round_step`` (also on a second launch) and K3 ``queue_ingest``
bit-exact, floats compared as bit patterns, K4 ``weight_update``
to rtol 1e-4 / atol 1e-5 (the reference's own tolerance) and bitwise
equal to itself; the engines, chaos features and sharded ranks through
them; and the LM stack and TMSN-SGD (a bf16 backward that repeats bit
for bit, the engine equal to the oracle, the program's tracer adding no
device interval), and the serving tier (in-place
decode bit for bit the out-of-place one, a server run with admission
and adoption equal to the CPU's). Imports no JAX,
so it runs on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test needs a CUDA device (marker ``cuda``) and skips without one.
The inputs are the ones tests/test_torch_kernels.py holds the plain
versions to against the JAX reference.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _scan_inputs(seed, w, n, d, num_bins, lo=0, hi=None):
    """Weights in [0.05, 1.05); from n = 100 000 rows on, multiples of 1/64
    in [1/64, 1] instead, whose float32 sums are exact in any order: there
    the plain version's own rounding (up to ~1e-3 over 180 000 float rows)
    would exceed the 1e-5 tolerance, and the comparison is of the kernel's
    indexing, not of two summation orders."""
    rng = np.random.default_rng(seed)
    xb = rng.integers(lo, num_bins if hi is None else hi, (w, n, d), dtype=np.int32)
    if n >= 100_000:
        wt = (rng.integers(1, 65, (w, n)) / 64).astype(np.float32)
    else:
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



def _ingest_edge_inputs(seed, w, cap, m):
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, -1.0, -0.5, -0.25], np.float32)

    def leaves(k):
        return (
            pool[rng.integers(0, len(pool), (w, k))],
            rng.integers(-1, 2, (w, k), dtype=np.int32),
            rng.integers(-1, 3, (w, k), dtype=np.int32),
            rng.integers(0, 2, (w, k), dtype=np.int32),
        )

    return leaves(cap) + leaves(m)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _cuda(arrays, dev):
    return [_t(a).to(dev) for a in arrays]


def _assert_scan(args, num_bins):
    """Bitwise equal on a second launch (no float atomics) and allclose
    1e-5 to the plain version."""
    got = tops.edge_scan(*args, num_bins=num_bins)
    again = tops.edge_scan(*args, num_bins=num_bins)
    plain = tref.edge_scan_ref(*args, num_bins)
    for a, b, c in zip(got, again, plain):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "w,n,d,num_bins",
    [
        (10, 2048, 64, 8),  # the engine's main path
        (256, 2048, 64, 8),
        (1, 2048, 64, 8),  # the event simulator's scan segments
        (1, 180_000, 64, 8),  # exact greedy over the training split
        (3, 100, 33, 5),
        (2, 7, 4, 16),
        (4, 2039, 64, 8),  # n prime: no tile divides it
        (3, 1000, 33, 1),
        (2, 513, 4, 2),
        (5, 300, 16, 17),
        (2, 250, 8, 32),
        (1, 0, 8, 8),
    ],
)
def test_cuda_edge_scan(cuda_device, w, n, d, num_bins):
    _assert_scan(_cuda(_scan_inputs(w + n, w, n, d, num_bins), cuda_device), num_bins)


@pytest.mark.cuda
@pytest.mark.parametrize("w,n", [(20, 2048), (256, 2048), (4, 20_000), (16, 20_000)])
def test_cuda_edge_scan_worker_sums_independent_of_w(cuda_device, w, n):
    """A worker's histogram and sums are the same bits in a launch over W
    workers and in one over a slice of them (the sharded engine's ranks
    scan W_local workers where one device scans W). At W = 256 (n = 2048)
    and W = 16 (n = 20 000, two levels) the whole batch folds each group
    of tiles in one block, and the slices run a block a tile."""
    xb, wy, w_ = _cuda(_scan_inputs(w, w, n, 64, 8), cuda_device)
    whole = tops.edge_scan(xb, wy, w_, num_bins=8)
    for lo, hi in ((0, 1), (1, w // 4 + 1), (w // 2, w)):
        part = tops.edge_scan(xb[lo:hi].contiguous(), wy[lo:hi].contiguous(), w_[lo:hi].contiguous(),
                              num_bins=8)
        for a, b in zip(whole, part):
            assert torch.equal(a[lo:hi], b), (lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("d,num_bins", [(64, 8), (33, 5), (4, 32)])
def test_cuda_edge_scan_bins_outside_range(cuda_device, d, num_bins):
    """Bins below 0 and at or above B add nothing, as in the plain version."""
    arrays = _scan_inputs(d, 3, 777, d, num_bins, lo=-2, hi=num_bins + 3)
    _assert_scan(_cuda(arrays, cuda_device), num_bins)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 4])
def test_cuda_edge_scan_misaligned_xb(cuda_device, d):
    """xb taken as a contiguous slice one int past a 16-byte boundary: the
    kernel must not issue 16-byte loads from it."""
    xb, wy, w = _scan_inputs(d + 1, 2, 600, d, 8)
    flat = torch.zeros(xb.size + 1, dtype=torch.int32, device=cuda_device)
    flat[1:] = _t(xb.reshape(-1)).to(cuda_device)
    xb_view = flat[1:].view(xb.shape)
    assert xb_view.is_contiguous() and xb_view.data_ptr() % 16 != 0
    args = [xb_view, *_cuda((wy, w), cuda_device)]
    _assert_scan(args, 8)
    aligned = tops.edge_scan(*_cuda((xb,), cuda_device), *args[1:], num_bins=8)
    for a, b in zip(aligned, tops.edge_scan(*args, num_bins=8)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(180_000, 64), (2, 500, 16), (3, 1, 7, 64)])
def test_cuda_edge_histogram(cuda_device, shape):
    """The baselines' histogram on the card goes through K1: the same bits
    on two calls, and allclose 1e-5 to the plain ``index_add_`` version."""
    from repro_torch.boosting.stumps import edge_histogram, edge_histogram_plain

    rng = np.random.default_rng(len(shape))
    xb = _t(rng.integers(0, 8, shape, dtype=np.int32)).to(cuda_device)
    # multiples of 1/64: index_add_'s float atomics add them exactly in any order
    wy = _t((rng.integers(-64, 65, shape[:-1]) / 64).astype(np.float32)).to(cuda_device)
    tops.reset_launches()
    got = edge_histogram(xb, wy, 8)
    again = edge_histogram(xb, wy, 8)
    assert tops.LAUNCHES["edge_scan"] == 2
    assert got.shape == (*shape[:-2], shape[-1], 8)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, edge_histogram_plain(xb, wy, 8), rtol=1e-5, atol=1e-5)


def _bits(t):
    """Bit pattern of a tensor: torch.equal calls -0.0 and +0.0 equal."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _round_edge_inputs(seed, w, cap):
    """Certs from a pool with +-0.0, +-inf and NaN, due in {-1, 0, 1}, src
    and slot from tiny ranges (ties in cert -> src -> slot are common),
    about a third of the rows dead."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -0.5, -0.25], np.float32)
    return (
        pool[rng.integers(0, len(pool), (w, cap))],
        rng.integers(-1, 2, (w, cap), dtype=np.int32),
        rng.integers(-1, 3, (w, cap), dtype=np.int32),
        rng.integers(0, 2, (w, cap), dtype=np.int32),
        pool[rng.integers(4, len(pool), w)],
        rng.random(w) < 0.7,
        rng.random(w).astype(np.float32),
        rng.random(w).astype(np.float32),
    )


def _assert_round(args, rounds=(0, 2)):
    """Bitwise equal to the plain version, and to itself on a second launch."""
    for r in rounds:
        got = tops.round_deliver(*args, r, eps=0.01)
        again = tops.round_deliver(*args, r, eps=0.01)
        plain = tref.round_step_ref(*args, r, eps=0.01)
        for a, b, c in zip(got, again, plain):
            assert torch.equal(_bits(a), _bits(b))
            assert torch.equal(_bits(a), _bits(c))


@pytest.mark.cuda
@pytest.mark.parametrize("w,cap", [(10, 64), (4096, 64), (10240, 64), (7, 5), (3, 3500)])
def test_cuda_round_step(cuda_device, w, cap):
    _assert_round(_cuda(_round_inputs(w, w, cap), cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "w,cap",
    [
        (10, 64),  # the engine's main path: two rows a warp
        (37, 64),  # W not a multiple of the rows a block holds
        (33, 1),  # C = 1: 32 rows a warp
        (9, 3),  # C not a multiple of 4: one entry a load
        (5, 100),
        (3, 3500),  # rows longer than a warp's loads
    ],
)
def test_cuda_round_step_edge_values(cuda_device, w, cap):
    """+-0.0 ties in one row, +-inf and NaN certs, ties in cert and src,
    due = -1 and dead destinations."""
    _assert_round(_cuda(_round_edge_inputs(w * cap, w, cap), cuda_device), rounds=(0, 1))


@pytest.mark.cuda
def test_cuda_round_step_signed_zero_rows(cuda_device):
    """A tie at zero with mixed signs gives -0.0 whatever the order."""
    for row in ([0.0, -0.0], [-0.0, 0.0], [0.0, -0.0, 0.0, -0.0, -0.0], [0.0, 0.0, -0.0, 0.0]):
        c = len(row)
        args = _cuda((np.array([row], np.float32), np.zeros((1, c), np.int32),
                      np.arange(c, 0, -1, dtype=np.int32)[None], np.arange(c, dtype=np.int32)[None],
                      np.zeros(1, np.float32), np.ones(1, bool), np.zeros(1, np.float32),
                      np.ones(1, np.float32)), cuda_device)
        _assert_round(args, rounds=(0,))
        assert int(_bits(tops.round_deliver(*args, 0, eps=0.0)[1])[0]) == -(2**31)


@pytest.mark.cuda
def test_cuda_round_step_misaligned_queue(cuda_device):
    """Queue leaves one element past a 16-byte boundary: the kernel must
    take one entry a load, and give the same bits."""
    arrays = _round_inputs(4, 12, 64)
    args = _cuda(arrays, cuda_device)
    shifted = []
    for a in args[:4]:
        flat = torch.zeros(a.numel() + 1, dtype=a.dtype, device=cuda_device)
        flat[1:] = a.reshape(-1)
        shifted.append(flat[1:].view(a.shape))
    assert all(t.data_ptr() % 16 != 0 for t in shifted)
    _assert_round(shifted + args[4:])
    for a, b in zip(tops.round_deliver(*args, 2, eps=0.01), tops.round_deliver(*shifted, *args[4:], 2, eps=0.01)):
        assert torch.equal(_bits(a), _bits(b))


def _assert_ingest(args):
    got = tops.queue_ingest(*args)
    plain = tref.queue_ingest_ref(*args)
    for a, b in zip(got, plain):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "w,cap,m",
    [
        (10, 64, 1),  # the engine's main path
        (4096, 64, 1),
        (4096, 64, 8),
        (7, 4, 3),
        (5, 100, 40),  # C + m > 64
        (9, 1, 3),  # C = 1
        (6, 4, 12),  # m > C
        (3, 3500, 20),  # a thread per several entries, > 48 KB of shared memory
    ],
)
def test_cuda_queue_ingest(cuda_device, w, cap, m):
    _assert_ingest(_cuda(_ingest_inputs(w + m, w, cap, m), cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("w,cap,m", [(64, 64, 1), (33, 16, 8), (5, 3, 9)])
def test_cuda_queue_ingest_edge_values(cuda_device, w, cap, m):
    """+-0.0 and +-inf certificates, duplicate (cert, src, due) entries and
    due = -1 padding, drawn from small pools so that ties are common."""
    _assert_ingest(_cuda(_ingest_edge_inputs(w * cap + m, w, cap, m), cuda_device))


@pytest.mark.cuda
def test_cuda_queue_ingest_all_inf_queue(cuda_device):
    """An all-+inf queue: the order among +inf entries (src, due, column)
    still decides which survive."""
    w, cap, m = 12, 16, 4
    args = list(_ingest_edge_inputs(3, w, cap, m))
    args[0] = np.full((w, cap), np.inf, np.float32)
    _assert_ingest(_cuda(args, cuda_device))
    args[4] = np.full((w, m), np.inf, np.float32)
    _assert_ingest(_cuda(args, cuda_device))


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


# ---------------------------------------------------------------------------
# the inputs fault injection gives K2 and K3, and chaos runs on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("w,cap,m", [(10, 64, 1), (10, 64, 10), (33, 16, 8), (5, 3, 9)])
def test_cuda_queue_ingest_duplicate_pairs(cuda_device, w, cap, m):
    """A candidate block that is all duplicate pairs, as a FaultPlan's
    duplicates make it: column j + m an identical copy of column j (or
    padding), so equal entries tie in K3's order up to their column."""
    q = list(_ingest_inputs(w * cap, w, cap, m))
    rng = np.random.default_rng(m)
    dup = rng.random((w, m)) < 0.7
    q[4] = np.concatenate([q[4], np.where(dup, q[4], np.inf).astype(np.float32)], axis=1)
    q[5] = np.concatenate([q[5], np.where(dup, q[5], -1).astype(np.int32)], axis=1)
    q[6] = np.concatenate([q[6], q[6]], axis=1)
    q[7] = np.concatenate([q[7], q[7]], axis=1)
    _assert_ingest(_cuda(q, cuda_device))
    edge = list(_ingest_edge_inputs(w + cap, w, cap, m))
    _assert_ingest(_cuda(edge[:4] + [np.concatenate([a, a], axis=1) for a in edge[4:]], cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("w,cap", [(10, 64), (37, 64), (9, 3), (3, 3500)])
def test_cuda_round_step_identical_entries_and_late_dues(cuda_device, w, cap):
    """Rows holding two identical due entries (a duplicate) and dues
    beyond r (a reordered delivery): one argmin, both copies cleared,
    the late entries left."""
    q_cert, q_due, q_src, q_slot, *rest = _round_inputs(w + cap, w, cap)
    r = 2
    rng = np.random.default_rng(cap)
    q_due = np.where(rng.random((w, cap)) < 0.5, r, r + rng.integers(1, 3, (w, cap))).astype(np.int32)
    half = cap // 2
    if half:
        for a in (q_cert, q_due, q_src, q_slot):
            a[:, half : 2 * half] = a[:, :half]
    args = _cuda((q_cert, q_due, q_src, q_slot, *rest), cuda_device)
    _assert_round(args, rounds=(r, r + 1))
    cleared = tops.round_deliver(*args, r, eps=0.01)[0]
    if half:
        assert torch.equal(_bits(cleared[:, :half]), _bits(cleared[:, half : 2 * half]))


class _ToyWorker:
    """The toy worker of tests/test_torch_engine.py on any device: worker
    i fires every ``period[i]``-th segment, its certificate then drops to
    ``-dec[i] * fires``."""

    def __init__(self, period, dec, device):
        self._period = torch.tensor(period, dtype=torch.int32, device=device)
        self._dec = torch.tensor(dec, dtype=torch.float32, device=device)

    def init_batch(self, n_workers, seed):
        dev = self._period.device
        z = torch.zeros((n_workers,), dtype=torch.int32, device=dev)
        return {"segs": z, "fires": z.clone(), "cert": torch.zeros((n_workers,), device=dev),
                "from": torch.full((n_workers,), -1, dtype=torch.int32, device=dev),
                "owner": torch.arange(n_workers, dtype=torch.int32, device=dev),
                "period": self._period.clone(), "dec": self._dec.clone()}

    def scan_round(self, state, mask):
        segs = state["segs"] + mask.to(torch.int32)
        fired = mask & (segs % state["period"] == 0)
        fires = state["fires"] + fired.to(torch.int32)
        cert = torch.where(fired, torch.minimum(state["cert"], -state["dec"] * fires), state["cert"])
        return dict(state, segs=segs, fires=fires, cert=cert), mask.to(torch.float32), fired

    def certificates(self, state):
        return state["cert"]

    def export_models(self, state):
        return {"owner": state["owner"], "cert": state["cert"], "adopted_from": state["from"]}

    def adopt_batch(self, state, models, certs, take):
        new = dict(state, cert=torch.where(take, certs, state["cert"]))
        new["from"] = torch.where(take, models["owner"], state["from"])
        return new, torch.zeros_like(state["cert"])

    def payload_bytes(self):
        return 8


def _toy_run(device, **kw):
    from repro_torch.core.engine import EngineConfig, TMSNEngine

    w = 8
    cfg = dict(n_workers=w, max_rounds=24, delay_rounds=1, seed=0, fault_spec="", rounds_per_dispatch=8,
               gossip_mode="dense", publish_every_k=0, spare_slots=0, inflight_capacity=16,
               control_plane="sparse", gossip_top_k=w, round_step_impl="pallas")
    cfg.update(kw)
    worker = _ToyWorker([1, 2, 3, 1, 2, 3, 1, 2], [0.5, 0.9, 1.3, 0.7, 1.1, 0.6, 0.8, 1.0], device)
    return TMSNEngine(worker, EngineConfig(**cfg), device=device).run()


def _same_run(a, b):
    assert a.final_certificates == b.final_certificates and a.history == b.history
    for f in ("rounds", "messages_sent", "messages_accepted", "messages_discarded", "messages_evicted",
              "messages_dropped_injected", "messages_corrupt_rejected", "workers_joined",
              "inflight_occupancy_peak"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["sparse", "dense"])
def test_cuda_composed_chaos_kernels_equal_plain(cuda_device, plane):
    """Drop, dup, corrupt and reorder with churn at toy scale: K2 and K3
    on the card equal their plain versions on the card bit for bit, and
    the CPU run."""
    from repro_torch.core.engine import FaultPlan, MembershipPlan

    kw = dict(control_plane=plane, spare_slots=2,
              membership=MembershipPlan(joins=((6, 6), (10, 7)), leaves=((12, 0),)),
              fault_plan=FaultPlan(drop_prob=0.1, duplicate_prob=0.3, corrupt_prob=0.2, reorder_max=2, seed=13))
    tops.reset_launches()
    kern = _toy_run(cuda_device, **kw)
    assert tops.LAUNCHES["round_step"] == 24
    assert tops.LAUNCHES["queue_ingest"] == (24 if plane == "sparse" else 0)
    plain = _toy_run(cuda_device, round_step_impl="ref", **kw)
    _same_run(kern, plain)
    _same_run(kern, _toy_run("cpu", **kw))
    assert kern.messages_dropped_injected > 0 and kern.messages_corrupt_rejected > 0
    assert kern.workers_joined == 2


@pytest.mark.cuda
def test_cuda_duplication_equals_clean(cuda_device):
    from repro_torch.core.engine import FaultPlan

    clean = _toy_run(cuda_device)
    dup = _toy_run(cuda_device, fault_plan=FaultPlan(duplicate_prob=0.5, seed=5))
    assert dup.final_certificates == clean.final_certificates and dup.history == clean.history
    assert dup.messages_evicted == 0


@pytest.mark.cuda
def test_cuda_eviction_lemma_capacity_one_through_k3(cuda_device):
    """The eviction lemma of tests/test_properties.py at capacity 1,
    through K3: the scores offered as one candidate list, every
    destination keeps the best certificate of the other workers, and the
    kernel's queue equals the plain version's bit for bit. Bounds
    float32 can represent."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    from repro_torch.core.engine import _empty_queue, _queue_push_candidates

    @hyp.settings(deadline=None, max_examples=30)
    @hyp.given(st.lists(st.floats(min_value=-100.0, max_value=float(np.float32(-0.01)), width=32),
                        min_size=2, max_size=12))
    def prop(scores):
        w = len(scores)
        score = torch.tensor(scores, dtype=torch.float32, device=cuda_device)
        ids = torch.arange(w, dtype=torch.int32, device=cuda_device)
        delay = torch.ones((w, w), dtype=torch.int32, device=cuda_device)
        alive = torch.ones((w,), dtype=torch.bool, device=cuda_device)
        args = (_empty_queue(w, 1, cuda_device), score, ids, alive, ids, delay, 0, 8)
        tops.reset_launches()
        kern = _queue_push_candidates(*args, "pallas")
        assert tops.LAUNCHES["queue_ingest"] == 1
        plain = _queue_push_candidates(*args, "ref")
        for a, b in zip(kern[0], plain[0]):
            assert torch.equal(_bits(a), _bits(b))
        assert [int(x) for x in kern[1:3]] == [int(x) for x in plain[1:3]]
        kept = kern[0].cert[:, 0].cpu().numpy()
        sc = np.asarray(scores, np.float32)
        for dst in range(w):
            assert kept[dst] == min(sc[src] for src in range(w) if src != dst)

    prop()


def _sharded_toy_rank(mesh, kw):
    """One rank of a world sharing the card: the toy run of ``_toy_run``
    through the sharded engine, with this rank's kernel launches."""
    from repro_torch.core.engine import EngineConfig, make_engine

    w = 8
    cfg = dict(n_workers=w, max_rounds=24, delay_rounds=1, seed=0, fault_spec="", rounds_per_dispatch=8,
               gossip_mode="dense", publish_every_k=0, spare_slots=0, inflight_capacity=16,
               control_plane="sparse", gossip_top_k=w, round_step_impl="pallas", mesh=mesh)
    cfg.update(kw)
    worker = _ToyWorker([1, 2, 3, 1, 2, 3, 1, 2], [0.5, 0.9, 1.3, 0.7, 1.1, 0.6, 0.8, 1.0], mesh.device)
    tops.reset_launches()
    res = make_engine(worker, EngineConfig(**cfg)).run()
    fields = ("final_certificates", "history", "rounds", "messages_sent", "messages_accepted",
              "messages_discarded", "messages_evicted", "inflight_occupancy_peak", "messages_sent_dcn")
    return {f: getattr(res, f) for f in fields} | {"launches": dict(tops.LAUNCHES),
                                                   "host_staged": mesh.host_staged}


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["sparse", "dense"])
def test_cuda_sharded_engine_two_ranks_share_the_card(cuda_device, tmp_path, plane):
    """Two gloo ranks on one card (collectives staged through the host),
    each launching K2 (and K3 under sparse control) over its 4 workers
    every round: the single-device run on the card, bit for bit (with
    gossip_top_k = W every improver is offered, so every counter too)."""
    from repro_torch.launch.mesh import spawn_world

    res = spawn_world(_sharded_toy_rank, ["cuda:0", "cuda:0"], tmp_path, args=(dict(control_plane=plane),))
    single = _toy_run(cuda_device, control_plane=plane)
    for r in res:
        assert r["host_staged"]
        assert r["launches"]["round_step"] == 24
        assert r["launches"]["queue_ingest"] == (24 if plane == "sparse" else 0)
        for f in ("final_certificates", "history", "rounds", "messages_sent", "messages_accepted",
                  "messages_discarded", "messages_evicted", "inflight_occupancy_peak"):
            assert r[f] == getattr(single, f), f


@pytest.mark.cuda
def test_cuda_pod_engine_four_ranks_share_the_card(cuda_device, tmp_path):
    """Four gloo ranks on one card in 2 pods of 2 (W_local = 2), sparse
    control on the queues, cross_pod_every_k = 1: the single-device run
    on the card in certificates, history and accepted; K2 once and K3
    twice a round on every rank (tier 1 and the cross-pod flush)."""
    from repro_torch.launch.mesh import spawn_world

    res = spawn_world(_sharded_toy_rank, ["cuda:0"] * 4, tmp_path,
                      args=(dict(cross_pod_every_k=1, cross_pod_top_k=1),), pods=2)
    single = _toy_run(cuda_device, control_plane="sparse")
    for r in res:
        assert r["host_staged"]
        assert r["launches"]["round_step"] == 24
        assert r["launches"]["queue_ingest"] == 48
        for f in ("final_certificates", "history", "rounds", "messages_accepted"):
            assert r[f] == getattr(single, f), f
        assert 0 < r["messages_sent_dcn"] < r["messages_sent"]
        assert r["messages_sent"] == res[0]["messages_sent"]


# ---------------------------------------------------------------------------
# K5 adamw_step: the SGD worker's AdamW step, bit for bit the plain update
# ---------------------------------------------------------------------------

_ADAMW_PAIRS = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32"),
                ("bfloat16", "bfloat16")]
#: odd lengths: no 16-byte vector covers them, the last tile is partial
_ODD_SHAPES = [(1,), (7,), (1023,), (4097, 3), (4096 * 3 + 5,)]


def _yi9b_l1_shapes():
    """Every leaf shape of Yi-9B's one-layer model (embedding 64 000 x 4 096)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=1)
    return [tuple(a.shape) for a in tree_leaves(init_params(cfg, 0, "meta"))]


def _adamw_inputs(dev, shapes, pdt, sdt, seed, misaligned=()):
    """(p, g, mu, nu) per shape, nu >= 0; the leaves whose index is in
    ``misaligned`` start one element past a 16-byte boundary."""
    import math

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(i, shape, dt, scale, positive=False):
        n = math.prod(shape)
        off = 1 if i in misaligned else 0
        t = torch.empty((n + off,), dtype=dt, device=dev)[off:].view(shape)
        v = torch.randn(shape, generator=gen, device=dev) * scale
        t.copy_(v.abs() if positive else v)
        return t

    return [(draw(i, s, pdt, 1.0), draw(i, s, pdt, 1e-2), draw(i, s, sdt, 1e-2), draw(i, s, sdt, 1e-4, True))
            for i, s in enumerate(shapes)]


def _assert_plain(leaves, outs, b1c, b2c, lr, cfg):
    """Each leaf's outputs equal ``_update``'s, bit for bit (one leaf's
    plain step alive at a time)."""
    from repro_torch.optim.adamw import _update

    for (p, g, mu, nu), got in zip(leaves, outs):
        want = _update(p, g, mu, nu, b1c, b2c, lr, cfg)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), tuple(p.shape)
        del want


@pytest.mark.cuda
@pytest.mark.parametrize("pdt,sdt", _ADAMW_PAIRS)
def test_cuda_adamw_step_equals_the_plain_update(cuda_device, pdt, sdt):
    """K5 over every leaf shape of Yi-9B's one-layer model, odd lengths
    and misaligned starts, in one launch: ``_update``'s bits, into other
    tensors and in place, with lr a float and a 0-d tensor, and again on
    a second launch."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import _corrections

    cfg = AdamWConfig(lr=3e-4, state_dtype=sdt)
    pdt, sdt = getattr(torch, pdt), getattr(torch, sdt)
    shapes = _yi9b_l1_shapes() + _ODD_SHAPES
    n = len(shapes)
    leaves = _adamw_inputs(cuda_device, shapes, pdt, sdt, 0, misaligned={1, n - 1, n - 3})
    b1c, b2c = _corrections(torch.full((), 5, dtype=torch.int32, device=cuda_device), cfg)
    outs = [(torch.empty_like(p), torch.empty_like(mu), torch.empty_like(nu)) for p, _, mu, nu in leaves]
    for lr in (cfg.lr, torch.full((), 1e-3, dtype=torch.float32, device=cuda_device)):
        for _ in range(2):
            tops.reset_launches()
            tops.adamw_step([(*leaf, *out) for leaf, out in zip(leaves, outs)], b1c, b2c, lr, cfg)
            assert tops.LAUNCHES["adamw_step"] == 1
            _assert_plain(leaves, outs, b1c, b2c, lr, cfg)
        # in place: the outputs are the inputs
        for (p, _, mu, nu), out in zip(leaves, outs):
            for dst, src in zip(out, (p, mu, nu)):
                dst.copy_(src)
        tops.adamw_step([(p2, g, m2, n2, p2, m2, n2) for (_, g, _, _), (p2, m2, n2) in zip(leaves, outs)],
                        b1c, b2c, lr, cfg)
        _assert_plain(leaves, outs, b1c, b2c, lr, cfg)


@pytest.mark.cuda
def test_cuda_adamw_step_splits_a_large_table(cuda_device):
    """More leaves than one launch's table, of two dtype pairs in one
    call: one launch a run of at most ADAMW_MAX_LEAVES leaves of a pair,
    every leaf ``_update``'s bits."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import _corrections

    cfg = AdamWConfig(lr=1e-2)
    m = tops.ADAMW_MAX_LEAVES
    shapes = [(1 + 37 * i,) for i in range(2 * m + 3)]
    f32 = _adamw_inputs(cuda_device, shapes, torch.float32, torch.float32, 1, misaligned=set(range(0, 99, 7)))
    bf16 = _adamw_inputs(cuda_device, shapes[:5], torch.bfloat16, torch.float32, 2)
    leaves = f32[:m] + bf16 + f32[m:]
    outs = [(torch.empty_like(p), torch.empty_like(mu), torch.empty_like(nu)) for p, _, mu, nu in leaves]
    b1c, b2c = _corrections(torch.full((), 2, dtype=torch.int32, device=cuda_device), cfg)
    tops.reset_launches()
    tops.adamw_step([(*leaf, *out) for leaf, out in zip(leaves, outs)], b1c, b2c, cfg.lr, cfg)
    assert tops.LAUNCHES["adamw_step"] == 3 + 1
    _assert_plain(leaves, outs, b1c, b2c, cfg.lr, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
def test_cuda_adamw_step_in_rows_as_the_segment(cuda_device, sdt):
    """``apply_updates_`` as ``BatchedSGDWorker._segment`` calls it on
    stacked (W, ...) state: step 0 from worker 1's rows of the old state
    into its rows of the new one (the old rows read only, worker 0's new
    rows untouched), steps 1 and 2 in place; one K5 launch a step, each
    step ``_update``'s bits, counted as kernel leaves."""
    from repro_torch import trace
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, apply_updates_, init_opt_state
    from repro_torch.optim.adamw import _corrections, _update
    from repro_torch.tree import tree_leaves, tree_map

    cfg = AdamWConfig(lr=1e-2, state_dtype=sdt)
    one = init_params(_tiny_lm(), 0, cuda_device)
    params = tree_map(lambda a: torch.stack([a, a + 0.5]), one)
    opt = init_opt_state(params, cfg)
    opt["step"] = torch.zeros((2,), dtype=torch.int32, device=cuda_device)
    old = (params, opt)
    new = tree_map(lambda a: torch.full_like(a, 7), old)
    before = tree_map(torch.clone, old)
    row = lambda t: tree_map(lambda a: a[1], t)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    trace.disable()
    trace.collect()
    trace.enable()
    try:
        for k in range(3):
            src, dst = (row(old), row(new)) if k == 0 else (row(new), row(new))
            grads = tree_map(lambda a: torch.randn(a.shape, generator=gen, device=cuda_device) * 1e-2, src[0])
            b1c, b2c = _corrections(src[1]["step"] + 1, cfg)
            want = [_update(p, g, mu, nu, b1c, b2c, cfg.lr, cfg) for p, g, mu, nu in
                    zip(*(tree_leaves(t) for t in (src[0], grads, src[1]["mu"], src[1]["nu"])))]
            tops.reset_launches()
            apply_updates_(src[0], grads, src[1], cfg, out=dst)
            assert tops.LAUNCHES["adamw_step"] == 1
            got = zip(*(tree_leaves(t) for t in (dst[0], dst[1]["mu"], dst[1]["nu"])))
            assert all(torch.equal(a, b) for g_, w in zip(got, want) for a, b in zip(g_, w))
            assert int(dst[1]["step"]) == k + 1
        counters = trace.collect()["counters"]
    finally:
        trace.disable()
        trace.collect()
    assert counters["adamw_leaves"] == {"kernel": 3 * len(tree_leaves(one))}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(old), tree_leaves(before)))
    assert all(bool((a[0] == 7).all()) for a in tree_leaves(new))


@pytest.mark.cuda
def test_cuda_adamw_step_forces_no_sync(cuda_device):
    """A step through ``apply_updates_`` and ``apply_updates`` (lr a float
    and a 0-d tensor on the card) under the sync debug mode "error": no
    call waits for the card."""
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, apply_updates, apply_updates_, init_opt_state
    from repro_torch.tree import tree_map

    cfg = AdamWConfig(lr=1e-2)
    params = init_params(_tiny_lm(), 0, cuda_device)
    grads = tree_map(lambda a: torch.full_like(a, 1e-3), params)
    opt = init_opt_state(params, cfg)
    lr = torch.full((), 2e-3, dtype=torch.float32, device=cuda_device)
    apply_updates_(params, grads, opt, cfg)  # warm: builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        apply_updates_(params, grads, opt, cfg)
        apply_updates_(params, grads, opt, cfg, lr=lr)
        params, opt = apply_updates(params, grads, opt, cfg, lr=lr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(opt["step"]) == 4


# ---------------------------------------------------------------------------
# the LM stack and TMSN-SGD (no TPU kernel on this path: eager PyTorch)
# ---------------------------------------------------------------------------


def _tiny_lm(compute_dtype="float32", remat=False):
    from repro_torch.models.config import ArchConfig

    return ArchConfig(name="tiny-contract", arch_type="llama", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab=500, remat=remat, compute_dtype=compute_dtype)


@pytest.mark.cuda
def test_cuda_lm_backward_repeats_bit_for_bit(cuda_device):
    """Loss and every gradient of a bf16 forward with remat are the same
    bits on a second pass: no float atomics on the path (the embedding's
    backward sorts its indices; the gold logit's gather writes each
    address once)."""
    from repro_torch.data.tokens import stream_tokens, synthetic_token_batch
    from repro_torch.models import init_params, loss_fn
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _tiny_lm("bfloat16", remat=True)
    params = init_params(cfg, 0, cuda_device)
    # repeated tokens, so the embedding's backward sums several rows into one
    batch = synthetic_token_batch(stream_tokens(1, 0, (4, 64), 20, cuda_device))
    runs = []
    for _ in range(2):
        leaves = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
        loss, _ = loss_fn(leaves, cfg, batch)
        loss.backward()
        runs.append([loss.detach()] + [a.grad for a in tree_leaves(leaves)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [0, 4])
def test_cuda_sgd_engine_equals_oracle(cuda_device, capacity):
    """TMSN-SGD on the card: the round engine (dense buffer, or the
    sparse queues through K2/K3) and oracle_run, bit for bit."""
    import numpy as np

    from repro_torch.core.engine import EngineConfig, TMSNEngine
    from repro_torch.core.sgd_worker import lm_sgd_worker
    from repro_torch.core.tmsn_sgd import TMSNSGDConfig, oracle_run
    from repro_torch.optim import AdamWConfig

    worker = lm_sgd_worker(_tiny_lm(), AdamWConfig(lr=1e-2), TMSNSGDConfig(local_steps=2, ema=0.8),
                           batch_size=2, seq=16, device=cuda_device)
    cfg = EngineConfig(n_workers=4, eps=0.0, max_rounds=6, delay_rounds=1, seed=0, fault_spec="",
                       rounds_per_dispatch=1, inflight_capacity=capacity, control_plane="dense",
                       gossip_mode="dense", spare_slots=0, publish_every_k=0, round_step_impl="pallas")
    res = TMSNEngine(worker, cfg, device=cuda_device).run()
    orc = oracle_run(worker, 4, 6, eps=0.0, seed=0)
    assert np.asarray(res.final_certificates, np.float32).view(np.int32).tolist() == \
        orc.certs.view(np.int32).tolist()
    assert res.messages_accepted > 0 and np.all(np.diff(orc.history, axis=0) <= 0)


@pytest.mark.cuda
def test_cuda_tracer_adds_no_device_interval(cuda_device, monkeypatch):
    """With the program's tracer on, a profiler with CUDA activity sees
    each span only as a host event: no CUDA-typed event bears a span's
    name, and the device's busy time (the benchmark's union of kernel,
    copy and fill intervals) over TMSN-SGD engine runs is within 2 % of
    the same runs with the tracer off."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace
    from repro_torch.core.engine import EngineConfig, TMSNEngine
    from repro_torch.core.sgd_worker import lm_sgd_worker
    from repro_torch.core.tmsn_sgd import TMSNSGDConfig
    from repro_torch.models.config import ArchConfig
    from repro_torch.optim import AdamWConfig

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1] / "bench"))
    from harness.trace import read_profile

    arch = ArchConfig(name="tracer-card", arch_type="llama", num_layers=2, d_model=1024, num_heads=8,
                      num_kv_heads=4, d_ff=4096, vocab=32000, compute_dtype="bfloat16")
    worker = lm_sgd_worker(arch, AdamWConfig(lr=1e-3), TMSNSGDConfig(local_steps=2, ema=0.8),
                           batch_size=4, seq=256, device=cuda_device)
    cfg = EngineConfig(n_workers=2, eps=0.0, max_rounds=4, delay_rounds=1, seed=0, fault_spec="",
                       rounds_per_dispatch=1, inflight_capacity=0, control_plane="dense",
                       gossip_mode="dense", spare_slots=0, publish_every_k=0, round_step_impl="pallas")
    TMSNEngine(worker, cfg, device=cuda_device).run()  # warm
    busy, names = {True: 0.0, False: 0.0}, set()
    try:
        for on in (False, True, True, False):
            if on:
                trace.enable()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                TMSNEngine(worker, cfg, device=cuda_device).run()
                torch.cuda.synchronize()
            trace.disable()
            got = {s["name"] for s in trace.collect()["spans"]}
            assert bool(got) == on
            names |= got
            events = list(prof.events())
            host = {e.name for e in events if not str(e.device_type).endswith("CUDA")}
            assert not [e.name for e in events if str(e.device_type).endswith("CUDA") and e.name in names]
            assert got <= host
            busy[on] += read_profile(prof, 1.0)["busy_s"]
    finally:
        trace.disable()
        trace.collect()
    assert {"engine.round", "engine.ring", "sgd.adamw", "sgd.backward"} <= names
    assert abs(busy[True] - busy[False]) <= 0.02 * busy[False], busy


# ---------------------------------------------------------------------------
# the serving tier (no TPU kernel on this path: eager PyTorch)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_in_place_decode_equals_out_of_place(cuda_device, compute_dtype):
    """The server's in-place cached decode gives the out-of-place path's
    bits on the card (logits and caches), and copies no cache."""
    from repro_torch.launch.serving import rebuffer_caches
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _tiny_lm(compute_dtype)
    params = init_params(cfg, 0, cuda_device)
    toks = torch.randint(0, cfg.vocab, (3, 12), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    with torch.no_grad():
        _, pre = prefill(params, cfg, {"tokens": toks})
        a = rebuffer_caches(cfg, pre, 3, 24, 12, 0)
        b = tree_map(torch.clone, a)
        ptrs = [x.data_ptr() for x in tree_leaves(b)]
        tok = toks[:, -1:]
        for i in range(8):
            pos = torch.full((3,), 12 + i, dtype=torch.int32, device=cuda_device)
            la, a = decode_step(params, cfg, tok, a, pos)
            lb, b = decode_step(params, cfg, tok, b, pos, in_place=True)
            assert torch.equal(la, lb)
            tok = la[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    assert [x.data_ptr() for x in tree_leaves(b)] == ptrs
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.cuda
def test_cuda_server_run_matches_cpu(cuda_device):
    """A ContinuousServer run with continuous admission and two adoptions
    on the card gives the CPU's tokens, versions and counts; adoption
    writes into the server's own tensors."""
    from repro_torch.launch.serving import AdoptionSlot, ContinuousServer, Request, ServingConfig
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _tiny_lm()
    params = init_params(cfg, 0, "cpu")
    snaps = {2: init_params(cfg, 1, "cpu"), 5: init_params(cfg, 2, "cpu")}
    ps = np.random.default_rng(0).integers(0, cfg.vocab, (7, 8)).astype(np.int32)
    runs = []
    for dev in ("cpu", cuda_device):
        # a copy each: the CPU server adopts into the tensors it is given
        server = ContinuousServer(cfg, ServingConfig(slots=3, prompt_len=8, max_new=10),
                                  tree_map(torch.clone, params), device=dev)
        server.warmup()
        ptrs = [x.data_ptr() for x in tree_leaves(server.params)]
        slot = AdoptionSlot()

        def hook(_, step, slot=slot):
            if step in snaps:
                slot.publish(snaps[step], cert=1.0 / step)

        res, m = server.run([Request(rid=i, prompt=ps[i], max_new=2 + (i * 3) % 9) for i in range(7)],
                            slot=slot, step_hook=hook)
        assert m["adoptions"] == 2 and m["recompiles"] == 0 and m["dropped_requests"] == 0
        if dev != "cpu":
            assert [x.data_ptr() for x in tree_leaves(server.params)] == ptrs
        runs.append(([r.tokens.tolist() for r in res], [r.versions for r in res], m["decode_steps"]))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# the decoder-only families (no TPU kernel on this path: eager PyTorch)
# ---------------------------------------------------------------------------

FAMILY_IDS = ["deepseek_v3_671b", "grok1_314b", "gemma3_12b", "mamba2_1p3b", "zamba2_1p2b"]


def _family_run(cfg, params, tokens, steps=16):
    """Loss and gradients of one batch, prefill logits and ``steps``
    greedy decode tokens (rebuffered caches, in-place decode)."""
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.launch.serving import rebuffer_caches
    from repro_torch.models import decode_step, loss_fn, prefill
    from repro_torch.tree import tree_leaves, tree_map

    leaves = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    loss, _ = loss_fn(leaves, cfg, synthetic_token_batch(tokens))
    loss.backward()
    grads = [a.grad for a in tree_leaves(leaves)]
    b, s = tokens.shape
    with torch.no_grad():
        logits, pre = prefill(params, cfg, {"tokens": tokens})
        caches = rebuffer_caches(cfg, pre, b, s + steps, s, 0)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out = [tok]
        for i in range(steps - 1):
            lg, caches = decode_step(params, cfg, tok, caches, s + i, in_place=True)
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            out.append(tok)
    return [loss.detach(), logits] + grads, torch.cat(out, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_IDS)
def test_cuda_family_repeats_and_matches_cpu(cuda_device, arch):
    """reduced() in float32: loss, every gradient, prefill logits and 16
    greedy tokens are the same bits on a second run on the card (the MoE
    scatter and the SSD cumsum add no float in a varying order), and
    within rtol 1e-4 / atol 1e-5 of the output's scale of the CPU's,
    tokens equal."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    cfg = reduced(get_config(arch))
    params = init_params(cfg, 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 32)).astype(np.int32))
    cpu_vals, cpu_toks = _family_run(cfg, params, tokens)
    gpu = tree_map(lambda a: a.to(cuda_device), params)
    a_vals, a_toks = _family_run(cfg, gpu, tokens.to(cuda_device))
    b_vals, b_toks = _family_run(cfg, gpu, tokens.to(cuda_device))
    assert all(torch.equal(x, y) for x, y in zip(a_vals, b_vals)) and torch.equal(a_toks, b_toks)
    assert torch.equal(a_toks.cpu(), cpu_toks)
    for g, c in zip(a_vals, cpu_vals):
        scale = max(1.0, float(c.abs().max()))
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_IDS)
def test_cuda_family_decode_matches_full_forward(cuda_device, arch):
    """Teacher-forced decode from an empty cache against the full forward
    on the card, at the reference's 2e-2."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import decode_step, init_cache, init_params, layer_segments
    from repro_torch.models.model import _embed, _logits, _positions
    from repro_torch.models.transformer import forward_stack

    cfg = reduced(get_config(arch))
    params = init_params(cfg, 0, cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (1, 16)).astype(np.int32)).to(
        cuda_device)
    with torch.no_grad():
        x, _, _ = forward_stack(params["decoder"], layer_segments(cfg), cfg, _embed(params, cfg, tokens),
                                _positions(tokens), shared_params=params.get("shared_attn"))
        full = _logits(params, cfg, x)
        caches = init_cache(cfg, 1, 16, device=cuda_device)
        for i in range(16):
            lg, caches = decode_step(params, cfg, tokens[:, i:i + 1], caches, i)
            torch.testing.assert_close(lg[:, 0], full[:, i], rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2_1p3b", "deepseek_v3_671b"])
def test_cuda_family_server_matches_cpu(cuda_device, arch):
    """A ContinuousServer run with admission and an adoption on reduced
    Mamba2 (SSD state) and DeepSeek-V3 (MLA latents, MoE): the card's
    tokens, versions and counts equal the CPU's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serving import AdoptionSlot, ContinuousServer, Request, ServingConfig
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    cfg = reduced(get_config(arch))
    params, snap = init_params(cfg, 0, "cpu"), init_params(cfg, 1, "cpu")
    ps = np.random.default_rng(3).integers(0, cfg.vocab, (7, 8)).astype(np.int32)
    runs = []
    for dev in ("cpu", cuda_device):
        server = ContinuousServer(cfg, ServingConfig(slots=3, prompt_len=8, max_new=10),
                                  tree_map(torch.clone, params), device=dev)
        server.warmup()
        slot = AdoptionSlot()

        def hook(_, step, slot=slot):
            if step == 3:
                slot.publish(snap, cert=0.5)

        res, m = server.run([Request(rid=i, prompt=ps[i], max_new=2 + (i * 3) % 9) for i in range(7)],
                            slot=slot, step_hook=hook)
        assert m["adoptions"] == 1 and m["recompiles"] == 0 and m["dropped_requests"] == 0
        runs.append(([r.tokens.tolist() for r in res], [r.versions for r in res], m["decode_steps"]))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# DeepSeek-V3's block: sigmoid routing, drop-free grouped experts, the bias
# ---------------------------------------------------------------------------


def _tiny_dsv3(compute_dtype="bfloat16", remat=True, held=4):
    from repro_torch.models.config import ArchConfig

    return ArchConfig(name="tiny-dsv3", arch_type="moe", num_layers=3, d_model=128, num_heads=4,
                      num_kv_heads=4, d_ff=256, moe_d_ff=64, vocab=500, attention="mla", q_lora_rank=0,
                      kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                      num_experts=16, num_experts_per_tok=4, num_shared_experts=2, first_k_dense=1, router_score="sigmoid",
                      routed_scaling_factor=2.446, router_bias_rate=0.01, router_aux_coef=1e-3,
                      moe_dispatch="dropless", experts_held=held, remat=remat, compute_dtype=compute_dtype)


@pytest.mark.cuda
def test_cuda_grouped_experts_repeat_and_match_the_plain_path(cuda_device):
    """The drop-free MoE layer in bf16 on the card (``torch._grouped_mm``
    over the held experts, an empty group among them): forward and every
    gradient the same bits on a second pass, the empty expert's gradients
    exactly zero, and the output and gradients within bf16's rounding of
    the float32 plain path on the CPU (the loop of products)."""
    import dataclasses

    from repro_torch.models import init_params, moe
    from repro_torch.tree import tree_map

    cfg = _tiny_dsv3()
    lp = tree_map(lambda a: a[0], init_params(cfg, 0, device="cpu")["decoder"][1][0]["moe"])
    lp["router_bias"][2] = -10.0  # held expert 2 gets no token
    x = torch.randn((2, 256, 128), generator=torch.Generator().manual_seed(1))
    cot = torch.randn((2, 256, 128), generator=torch.Generator().manual_seed(2))

    def run(device, c):
        leaves = tree_map(lambda a: a.detach().clone().to(device).requires_grad_(True), lp)
        xx = x.to(device, c).requires_grad_(True)
        out, aux, (load, offs) = moe.moe_layer(leaves, xx, cfg if c == torch.bfloat16 else
                                               dataclasses.replace(cfg, compute_dtype="float32"))
        ((out.float() * cot.to(device)).sum() + aux).backward()
        grads = [xx.grad] + [leaves[k].grad for k in ("router", "gate", "up", "down")]
        return [out.detach(), aux.detach(), offs] + grads

    a, b = run(cuda_device, torch.bfloat16), run(cuda_device, torch.bfloat16)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    rows = torch.diff(a[2][:4].long(), prepend=a[2].new_zeros(1).long())
    assert int(rows[2]) == 0 and int(rows.sum()) > 0
    assert all(not bool(g[2].any()) for g in a[-3:])
    want = run("cpu", torch.float32)
    for got, w in zip([a[0]] + a[3:], [want[0]] + want[3:]):
        got, w = got.float().cpu(), w.float()
        assert float((got - w).abs().max()) <= 3e-2 * float(w.abs().max())


@pytest.mark.cuda
def test_cuda_moe_step_repeats_bit_for_bit(cuda_device):
    """A whole TMSN-SGD round of the sigmoid-routed MLA model with remat
    on the card (forward, backward through the grouped products, K5 on
    the trained leaves, the bias rule) twice: the same bits; K5 launches
    once a worker step and the bias is stepped."""
    from repro_torch.core.sgd_worker import lm_sgd_worker
    from repro_torch.core.tmsn_sgd import TMSNSGDConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves

    runs = []
    for _ in range(2):
        worker = lm_sgd_worker(_tiny_dsv3(), AdamWConfig(lr=1e-2, state_dtype="bfloat16"),
                               TMSNSGDConfig(local_steps=2, ema=0.8), batch_size=2, seq=64,
                               device=cuda_device)
        state = worker.init_batch(2, 0)
        tops.reset_launches()
        new, _, _ = worker.scan_round(state, torch.ones(2, dtype=torch.bool, device=cuda_device))
        torch.cuda.synchronize()
        assert tops.LAUNCHES["adamw_step"] == 2 * 2
        runs.append(tree_leaves((new.params, new.opt, new.cert)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    bias = new.params["decoder"][1][0]["moe"]["router_bias"]
    assert bool((bias != 0).any()) and new.opt["mu"]["decoder"][1][0]["moe"]["router_bias"] is None


@pytest.mark.cuda
def test_cuda_adamw_one_launch_for_yis_leaves_and_the_bias_left_out(cuda_device):
    """K5 steps Yi-9B's 12 leaves in one launch, as before the bias was
    left out of AdamW; on the MoE tree it steps the trained leaves in one
    launch and leaves the selection bias as it was."""
    from repro_torch import trace
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, trained
    from repro_torch.optim import AdamWConfig, apply_updates_, init_opt_state
    from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

    import dataclasses

    yi = dataclasses.replace(get_config("yi_9b"), num_layers=1, d_model=256, num_heads=4, num_kv_heads=2,
                             d_ff=512, vocab=1000)
    for cfg, n_trained in ((yi, 12), (_tiny_dsv3(), None)):
        params = init_params(cfg, 0, cuda_device)
        opt = init_opt_state(params, AdamWConfig(), trained=trained)
        named = {".".join(map(str, p)): a for p, a in tree_leaves_with_path(params)}
        want = sum(1 for k in named if not k.endswith("router_bias"))
        assert n_trained is None or want == n_trained
        bias = {k: a.clone() for k, a in named.items() if k.endswith("router_bias")}
        tops.reset_launches()
        trace.disable()
        trace.collect()
        trace.enable()
        try:
            apply_updates_(params, tree_map(torch.ones_like, params), opt, AdamWConfig(weight_decay=0.5))
            counts = trace.collect()["counters"]
        finally:
            trace.disable()
        assert tops.LAUNCHES["adamw_step"] == 1 and counts["adamw_leaves"] == {"kernel": want}
        assert all(torch.equal(named[k], v) for k, v in bias.items())
        assert len(tree_leaves(opt["mu"])) == want


# ---------------------------------------------------------------------------
# K6 attention: against models.attention._sdpa in float32 from the same
# bf16 inputs
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py, whose K6 checks these tests share: its cases, inputs,
    plain version and block errors, and K6_TOL with its reasons."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_smoke = _chip_smoke()
_K6_CASES = list(_smoke.K6_CASES)
#: every instance's checks: (head widths qk and v, b, s, H, K, window, positions)
_K6_ALL = [widths + case for widths, cases, _ in _smoke.K6_INSTANCES for case in cases]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dv,b,s,H,K,window,kind", _K6_ALL)
def test_cuda_attention_matches_float32_sdpa(cuda_device, hd, dv, b, s, H, K, window, kind):
    """K6's O and its dq, dk, dv within ``chip_smoke.K6_TOL`` of
    ``_sdpa`` in float32, block by block (``chip_smoke.k6_block_errors``), one
    forward and one backward launch a call, at each instance's widths."""
    pos = _smoke.k6_positions(kind, b, s, cuda_device)
    q, k, v, do = _smoke.k6_inputs(b, s, H, K, cuda_device, hd=hd, dv=dv)
    want = _smoke.k6_run(_smoke.k6_plain(pos, window), q, k, v, do, torch.float32)
    tops.reset_launches()
    got = _smoke.k6_run(_smoke.k6_kernel(pos, window), q, k, v, do, torch.bfloat16)
    assert (tops.LAUNCHES["attention_fwd"], tops.LAUNCHES["attention_bwd"]) == (1, 1)
    assert all(a.dtype == torch.bfloat16 and a.shape == w.shape for a, w in zip(got, want))
    err = dict(zip(("o", "dq", "dk", "dv"), _smoke.k6_block_errors(got, want)))
    assert all(e <= _smoke.K6_TOL for e in err.values()), err


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dv,b,s,H,K,window,kind", [(128, 128) + _K6_CASES[i] for i in (0, 4, 7)]
                         + [(192, 128) + case for case in _smoke.K6_MLA_REPEATED])
def test_cuda_attention_repeats_bit_for_bit(cuda_device, hd, dv, b, s, H, K, window, kind):
    """The forward and the backward give the same bits on a second call:
    no float atomics; a KV head's gradients sum its G query heads in a
    fixed order."""
    pos = _smoke.k6_positions(kind, b, s, cuda_device)
    q, k, v, do = _smoke.k6_inputs(b, s, H, K, cuda_device, seed=1, hd=hd, dv=dv)
    runs = [_smoke.k6_run(_smoke.k6_kernel(pos, window), q, k, v, do, torch.bfloat16) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.cuda
def test_cuda_attention_forces_no_sync(cuda_device):
    """K6's forward and backward under the sync debug mode "error": no
    call waits for the card."""
    pos = _smoke.k6_positions("index", 2, 300, cuda_device)
    q, k, v, do = _smoke.k6_inputs(2, 300, 8, 2, cuda_device)
    # warm: builds and loads the library
    _smoke.k6_run(_smoke.k6_kernel(pos, None), q, k, v, do, torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _smoke.k6_kernel(pos, None)(*leaves).backward(do)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(t.grad is not None for t in leaves)


@pytest.mark.cuda
def test_cuda_attention_yi_layer_remat_launches_and_repeats(cuda_device):
    """A bf16 Yi-9B layer (32 heads over 4 KV heads, head 128) with remat,
    through ``loss_fn``: K6's forward launches twice a step (the forward
    and remat's recompute) and its backward once, the tracer counts the
    two ``gqa_full`` calls at ``kernel``, and the loss and every gradient
    repeat bit for bit."""
    import dataclasses

    from repro_torch import trace
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import stream_tokens, synthetic_token_batch
    from repro_torch.models import init_params, loss_fn
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("yi_9b"), num_layers=1, d_ff=1024, vocab=2000, remat=True,
                              compute_dtype="bfloat16")
    params = init_params(cfg, 0, cuda_device)
    batch = synthetic_token_batch(stream_tokens(1, 0, (2, 512), cfg.vocab, cuda_device))
    runs = []
    trace.disable()
    trace.collect()
    for i in range(2):
        leaves = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
        tops.reset_launches()
        if i == 0:
            trace.enable()
        try:
            loss, _ = loss_fn(leaves, cfg, batch)
            loss.backward()
            counts = trace.collect()["counters"] if i == 0 else None
        finally:
            trace.disable()
        assert (tops.LAUNCHES["attention_fwd"], tops.LAUNCHES["attention_bwd"]) == (2, 1)
        if counts is not None:
            assert counts["attention_calls"] == {"kernel": 2}
        runs.append([loss.detach()] + [a.grad for a in tree_leaves(leaves)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype,route", [(128, "bfloat16", "kernel"), (64, "bfloat16", "plain"),
                                            (128, "float32", "plain")])
def test_cuda_gqa_full_routes_by_its_input(cuda_device, hd, dtype, route):
    """``gqa_full`` on the card runs K6 for bf16 at head 128 and ``_sdpa``
    otherwise (another head width, float32), with no mask built for K6;
    the tracer counts the route, and the plain route launches nothing."""
    import dataclasses

    from repro_torch import trace
    from repro_torch.models.attention import _causal_window_mask, _gqa_qkv, _sdpa, gqa_full, init_gqa
    from repro_torch.models.config import ArchConfig

    cfg = ArchConfig(name="route", arch_type="llama", num_layers=1, d_model=4 * hd, num_heads=4, num_kv_heads=2,
                     d_ff=64, vocab=100, head_dim=hd)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    dt = getattr(torch, dtype)
    params = init_gqa(gen, cfg, dt, cuda_device)
    x = torch.randn((2, 200, cfg.d_model), generator=gen, device=cuda_device).to(dt)
    pos = _smoke.k6_positions("index", 2, 200, cuda_device)
    tops.reset_launches()
    trace.disable()
    trace.collect()
    trace.enable()
    try:
        out, _ = gqa_full(params, x, pos, dataclasses.replace(cfg, compute_dtype=dtype))
        counts = trace.collect()["counters"]
    finally:
        trace.disable()
    assert counts["attention_calls"] == {route: 1}
    assert tops.LAUNCHES["attention_fwd"] == (route == "kernel")
    if route == "plain":  # the bits of _sdpa as before
        q, k, v = _gqa_qkv(params, x, pos, cfg)
        want = _sdpa(q.reshape(2, 200, 2, 2, hd), k, v, _causal_window_mask(pos, pos, None), hd ** -0.5)
        assert torch.equal(out, torch.matmul(want.reshape(2, 200, 4 * hd), params["wo"]))


# ---------------------------------------------------------------------------
# K6's (192, 128) instance and MLA's route to it (mla_full on CUDA bf16 at
# DeepSeek-V3's and Moonlight's widths: keys 128 + 64 rotary, values 128)
# ---------------------------------------------------------------------------

def _moonlight_mla():
    """Moonlight-16B-A3B's MLA (``bench/configs/moonlight_l5.json``): d
    2048, 16 heads, latent 512, keys 128 + 64 rotary, values 128."""
    from repro_torch.models.config import ArchConfig

    return ArchConfig(name="moonlight-mla", arch_type="moe", num_layers=1, d_model=2048, num_heads=16,
                      num_kv_heads=16, d_ff=64, vocab=100, attention="mla", q_lora_rank=0, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, rope_theta=50000.0,
                      compute_dtype="bfloat16")


def _traced(fn):
    """fn() with the tracer on: (its result, the counters)."""
    from repro_torch import trace

    trace.disable()
    trace.collect()
    trace.enable()
    try:
        out = fn()
        return out, trace.collect()["counters"]
    finally:
        trace.disable()


def _mla_errors(got, want, heads: int = 5):
    """[tensors of (b, s, heads, width) or (b, s, width) (the first
    ``heads``), then weight gradients] against float32 ones: block errors
    (``chip_smoke.k6_block_errors``) of the first, a 3-D one read as one
    head; each weight gradient's largest error over its largest value."""
    rows = [[t if t.dim() == 4 else t.unsqueeze(2) for t in ts[:heads]] for ts in (got, want)]
    return (_smoke.k6_block_errors(*rows)
            + [float((g.float() - w).abs().max() / w.abs().max()) for g, w in zip(got[heads:], want[heads:])])


#: the MLA layer's limits (block errors and weight gradients' largest error
#: over their largest value, against float32): ``chip_smoke.K6_TOL``, and
#: twice it for the query's gradients, where a query's dq cancels and dO
#: reaches K6 through ``wo``'s bf16 product, and for the whole bf16 layer,
#: whose projections round to bf16 too. The card read at most 0.0120 (dq)
#: through K6; the absorbed form in bf16 read 0.0227 and 0.0285 for dq and
#: 0.0136 for the whole layer's dx.
_MLA_DQ_TOL = _MLA_LAYER_TOL = 2 * _smoke.K6_TOL


@pytest.mark.cuda
def test_cuda_mla_full_takes_k6_at_moonlights_widths(cuda_device):
    """An MLA layer at Moonlight's widths in bf16 on the card (``mla_full``,
    forward and backward) attends expanded through K6: counted at
    ``kernel``, one forward and one backward launch; its output and every
    gradient repeat bit for bit; against the same layer in float32 (the
    absorbed route), its output's and input's block errors and each weight
    gradient's within ``_MLA_LAYER_TOL``. Its attention from the layer's
    own bf16 query and latent (``_mla_attend_k6``) against the absorbed
    ``_mla_attend`` in float32 from the same values: the block errors of the
    output and of the rotary key's and latent's gradients, and the weight
    gradients of ``wkv_b_k``, ``wkv_b_v`` and ``wo``, within
    ``chip_smoke.K6_TOL``; the query's gradients within ``_MLA_DQ_TOL``. The
    absorbed form's own errors in bf16 are printed beside them, a yardstick
    and no limit."""
    from repro_torch.models import attention as attn

    cfg = _moonlight_mla()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = attn.init_mla(gen, cfg, torch.float32, cuda_device)
    b, s = 2, 1024
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=cuda_device).to(torch.bfloat16)
    cot = torch.randn((b, s, cfg.d_model), generator=gen, device=cuda_device)
    pos = _smoke.k6_positions("index", b, s, cuda_device)

    def layer(dtype):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        xx = x.to(dtype).clone().requires_grad_(True)
        out, _ = attn.mla_full(leaves, xx, pos, cfg)
        (out.float() * cot).sum().backward()
        return [out.detach(), xx.grad] + [leaves[k].grad for k in sorted(leaves)]

    tops.reset_launches()
    got, counts = _traced(lambda: layer(torch.bfloat16))
    assert counts["mla_attend_calls"] == {"kernel": 1}
    assert (tops.LAUNCHES["attention_fwd"], tops.LAUNCHES["attention_bwd"]) == (1, 1)
    assert all(torch.equal(a, c) for a, c in zip(got, layer(torch.bfloat16)))
    whole = _mla_errors(got, layer(torch.float32), heads=2)
    print(f"MLA layer through K6 against float32: {['%.4f' % e for e in whole]}")
    assert all(e <= _MLA_LAYER_TOL for e in whole), whole

    with torch.no_grad():
        q_nope, q_rope = attn._mla_q(params, x, pos, cfg)
        c_kv, k_rope = attn._mla_kv_latent(params, x, pos, cfg)
    mask = attn._causal_window_mask(pos, pos, None)
    weights = ("wkv_b_k", "wkv_b_v", "wo")

    def attend(dtype, k6):
        ins = [t.to(dtype).clone().requires_grad_(True) for t in (q_nope, q_rope, c_kv, k_rope)]
        w = {k: params[k].clone().requires_grad_(True) for k in weights}
        if k6:
            out = attn._mla_attend_k6(w, *ins, pos, cfg, dtype)
        else:
            out = attn._mla_attend(w, attn._mla_absorb(w, ins[0], dtype), *ins[1:], mask, cfg, dtype)
        (out.float() * cot).sum().backward()
        return [out.detach()] + [t.grad for t in ins] + [w[k].grad for k in weights]

    want = attend(torch.float32, False)
    names = ["out", "dq_nope", "dq_rope", "dc_kv", "dk_rope"] + [f"d{k}" for k in weights]
    err = dict(zip(names, _mla_errors(attend(torch.bfloat16, True), want)))
    plain = dict(zip(names, _mla_errors(attend(torch.bfloat16, False), want)))
    print(f"MLA attention through K6 {err}; absorbed in bf16 {plain}")
    limits = {n: _MLA_DQ_TOL if n.startswith("dq_") else _smoke.K6_TOL for n in names}
    assert all(err[n] <= limits[n] for n in names), (err, limits)


@pytest.mark.cuda
def test_cuda_mla_prefill_through_k6_matches_decode(cuda_device):
    """A 16-token prompt at Moonlight's widths in bf16: ``mla_full``
    through K6 (counted at ``kernel``) against teacher-forced
    ``mla_decode`` from an empty latent cache (absorbed, counted at
    ``plain``), at the reference's 2e-2 of
    ``test_cuda_family_decode_matches_full_forward``."""
    from repro_torch.models import attention as attn

    cfg = _moonlight_mla()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    params = attn.init_mla(gen, cfg, torch.float32, cuda_device)
    x = torch.randn((1, 16, cfg.d_model), generator=gen, device=cuda_device).to(torch.bfloat16)
    pos = _smoke.k6_positions("index", 1, 16, cuda_device)

    def both():
        with torch.no_grad():
            full, _ = attn.mla_full(params, x, pos, cfg)
            ckv = torch.zeros((1, 16, cfg.kv_lora_rank), dtype=torch.bfloat16, device=cuda_device)
            kr = torch.zeros((1, 16, cfg.qk_rope_head_dim), dtype=torch.bfloat16, device=cuda_device)
            steps = []
            for i in range(16):
                out, ckv, kr = attn.mla_decode(params, x[:, i:i + 1], ckv, kr, i, cfg)
                steps.append(out[:, 0])
        return full, steps

    (full, steps), counts = _traced(both)
    assert counts["mla_attend_calls"] == {"kernel": 1, "plain": 16}
    for i, step in enumerate(steps):
        torch.testing.assert_close(step, full[:, i], rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# Nemotron-H's hybrid block at Nemotron 3 Nano's widths
# (``bench/configs/nemotron3nano_l7.json``): grouped Mamba-2 trained at 8k,
# K6 at 32 query heads over 2, the whole 7-block stack against float32
# ---------------------------------------------------------------------------

def _nemotron(pattern="MEMEM*E", compute_dtype="bfloat16"):
    """Nemotron 3 Nano's blocks: d 2688; Mamba-2 64 heads of 64 in 8 groups,
    state 128, conv 4, chunk 128; relu^2 experts of 1 856, 16 of 128 held,
    top-6, a shared expert of 3 712; 32 query heads over 2, head 128, no
    positions; an eighth of the vocabulary."""
    from repro_torch.models.config import ArchConfig

    return ArchConfig(name="nemotron-3-nano", arch_type="hybrid", num_layers=len(pattern), layer_pattern=pattern,
                      d_model=2688, num_heads=32, num_kv_heads=2, head_dim=128, d_ff=1856, moe_d_ff=1856,
                      vocab=16384, rope=False, mlp_gated=False, ssm_state=128, ssm_head_dim=64, ssm_heads=64,
                      ssm_groups=8, ssm_conv_width=4, ssm_chunk=128, num_experts=128,
                      num_experts_per_tok=6, num_shared_experts=2, expert_act="relu2", router_score="sigmoid",
                      routed_scaling_factor=2.5, router_bias_rate=0.001, router_aux_coef=1e-4,
                      moe_dispatch="dropless", experts_held=16, compute_dtype=compute_dtype, remat=True)


def _nemotron_arch(cfg) -> dict:
    import dataclasses

    return dataclasses.asdict(cfg)


def _mamba2_init_(params: dict, gen) -> None:
    """Mamba-2's A_log, dt_bias and D draws on (..., H) leaves, in place."""
    for name, a in params.items():
        u = torch.rand(a.shape, generator=gen, device=a.device)
        if name == "a_log":
            a.copy_(torch.log(1.0 + 15.0 * u))
        elif name == "dt_bias":
            dt = torch.exp(np.log(1e-3) + (np.log(0.1) - np.log(1e-3)) * u).clamp(min=1e-4)
            a.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif name == "D":
            a.copy_(u + 0.5)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


#: the Mamba-2 block in bf16 against float32: each of output, dx and the
#: weight gradients, the largest error over the largest value. bf16 rounds
#: the input, each weight and each product's inputs to 8 bits (2^-8 = 0.4 %
#: a rounding), summed over in_proj's 2 688 and the scan's 128-position
#: chunks; 3e-2 is the MoE card test's bound for the same rounding
_MAMBA2_BF16_TOL = 3e-2
#: the same block in float32 on both sides (TF32 off): only the order of
#: float32 sums differs (the port's loop over the 64 chunks against the
#: reference's one product over them)
_MAMBA2_F32_TOL = 1e-4


@pytest.mark.cuda
def test_cuda_mamba2_block_at_nemotron_widths_matches_float32(cuda_device):
    """One grouped Mamba-2 mixer at Nemotron 3 Nano's widths, b 1, s 8 192
    (64 chunks), forward and backward through ``ssd_full``: in bf16 within
    ``_MAMBA2_BF16_TOL`` of the float32 reference
    (``tests/plain/nemotron_h.py``), in float32 within ``_MAMBA2_F32_TOL``;
    ``ssm_calls`` counts one full call."""
    import dataclasses

    from plain import nemotron_h as nref
    from repro_torch.models import ssm

    cfg = _nemotron("M")
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(11)
    params = ssm.init_ssm(gen, cfg, torch.float32, cuda_device)
    _mamba2_init_(params, gen)
    params["conv_b"].normal_(generator=gen).mul_(0.1)
    x = torch.randn((1, 8192, cfg.d_model), generator=gen, device=cuda_device)
    cot = torch.randn((1, 8192, cfg.d_model), generator=gen, device=cuda_device)
    names = sorted(params)

    def port(dtype):
        c = cfg if dtype == torch.bfloat16 else dataclasses.replace(cfg, compute_dtype="float32")
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        xx = x.to(dtype).detach().clone().requires_grad_(True)
        out = ssm.ssd_full(leaves, xx, c)[0]
        (out.float() * cot).sum().backward()
        return [out.detach(), xx.grad] + [leaves[k].grad for k in names]

    with nref.exact_matmuls():
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        xx = x[0].clone().requires_grad_(True)
        out = nref.mamba2(xx, leaves, _nemotron_arch(cfg))
        (out * cot[0]).sum().backward()
        want = [out.detach()[None], xx.grad[None]] + [leaves[k].grad for k in names]
        f32 = port(torch.float32)
    got, counts = _traced(lambda: port(torch.bfloat16))
    labels = ["out", "dx"] + [f"d{k}" for k in names]
    bf16 = {n: _rel(g, w) for n, g, w in zip(labels, got, want)}
    exact = {n: _rel(g, w) for n, g, w in zip(labels, f32, want)}
    print(f"Mamba-2 block at 8k, bf16 against float32 {bf16}; float32 against float32 {exact}")
    assert counts["ssm_calls"] == {"full": 1}
    assert all(e <= _MAMBA2_BF16_TOL for e in bf16.values()), bf16
    assert all(e <= _MAMBA2_F32_TOL for e in exact.values()), exact


@pytest.mark.cuda
def test_cuda_attention_at_nemotron_heads_8k(cuda_device):
    """K6 at Nemotron 3 Nano's attention, 32 query heads over 2 KV heads of
    128 (16 a group), b 1, s 8 192: O, dq, dk, dv within ``K6_TOL`` of
    float32 ``_sdpa`` block by block, and the same bits on a second call."""
    pos = _smoke.k6_positions("index", 1, 8192, cuda_device)
    q, k, v, do = _smoke.k6_inputs(1, 8192, 32, 2, cuda_device, seed=3)
    got = _smoke.k6_run(_smoke.k6_kernel(pos, None), q, k, v, do, torch.bfloat16)
    again = _smoke.k6_run(_smoke.k6_kernel(pos, None), q, k, v, do, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = _smoke.k6_run(_smoke.k6_plain(pos, None), q, k, v, do, torch.float32)
    err = dict(zip(("o", "dq", "dk", "dv"), _smoke.k6_block_errors(got, want)))
    print(f"K6 at 32 / 2 heads, s 8192: {err}")
    assert all(e <= _smoke.K6_TOL for e in err.values()), err


@pytest.mark.cuda
def test_cuda_nemotron_stack_bf16_matches_float32(cuda_device):
    """The 7 published blocks (``MEMEM*E``) at Nemotron 3 Nano's widths in
    bf16 through ``loss_fn`` with remat (K6 taken, the grouped relu^2
    experts through ``torch._grouped_mm``), one sequence of 8 192 tokens,
    against the float32 reference: the loss and the worst leaf's gradient
    norm within the cell's own limits (``sgd.loss_gap``, ``sgd.grad_gap``
    of ``bench/limits/nemotron3nano_l7.sgd_zipf_8k.json``), measured as
    the cell's check measures them."""
    import json

    from plain import nemotron_h as nref
    from repro_torch.models import init_params, loss_fn
    from repro_torch.tree import tree_leaves_with_path

    cfg = _nemotron()
    params = init_params(cfg, 5, cuda_device)
    named = {".".join(map(str, p)): a for p, a in tree_leaves_with_path(params)}
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6)
    for prefix in {k.rsplit(".", 1)[0] for k in named if ".ssm." in k}:
        _mamba2_init_({k.rsplit(".", 1)[1]: v for k, v in named.items() if k.rsplit(".", 1)[0] == prefix}, gen)
    tok = torch.randint(0, cfg.vocab, (1, 8192), generator=gen, device=cuda_device)
    batch = {"tokens": tok, "labels": tok.roll(-1, 1), "mask": torch.ones((1, 8192), device=cuda_device)}
    limits = json.loads((Path(__file__).resolve().parents[1] / "bench" / "limits"
                         / "nemotron3nano_l7.sgd_zipf_8k.json").read_text())

    leaves = {k: v.detach().clone().requires_grad_(nref.trained(k)) for k, v in named.items()}
    tops.reset_launches()
    (loss, _), counts = _traced(lambda: loss_fn(_tree_of(params, leaves), cfg, batch))
    loss.backward()
    assert counts["attention_calls"] == {"kernel": 1} and counts["ssm_calls"] == {"full": 3}
    got = {k: float(torch.linalg.vector_norm(v.grad.double())) for k, v in leaves.items() if v.requires_grad}
    del leaves
    with nref.exact_matmuls():
        wts = {k: v.detach().clone().requires_grad_(nref.trained(k)) for k, v in named.items()}
        value, _, _ = nref.sequence_loss(wts, _nemotron_arch(cfg), tok[0], batch["labels"][0])
        value.backward()
    want = {k: float(torch.linalg.vector_norm(v.grad.double())) for k, v in wts.items() if v.requires_grad}
    loss_gap = abs(float(loss.detach()) - float(value.detach())) / abs(float(value.detach()))
    grad_gap = nref.worst_leaf_gap(got, want)
    print(f"7 blocks at 8k, bf16 against float32: loss gap {loss_gap:.6f}, grad gap {grad_gap:.6f}")
    assert loss_gap <= limits["sgd.loss_gap"] and grad_gap <= limits["sgd.grad_gap"], (loss_gap, grad_gap)


def _tree_of(params, named: dict):
    """``params``' tree with each leaf replaced by ``named``'s of its path."""
    from repro_torch.tree import tree_map_with_path

    return tree_map_with_path(lambda p, a: named[".".join(map(str, p))], params)
