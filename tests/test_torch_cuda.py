"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K1 ``edge_scan`` to 1e-5 and bitwise equal to itself on a second
launch (no float atomics), also through ``edge_histogram``, K2
``round_step`` (also on a second launch) and K3 ``queue_ingest``
bit-exact, floats compared as bit patterns, K4 ``weight_update``
to rtol 1e-4 / atol 1e-5 (the reference's own tolerance) and bitwise
equal to itself; the engines, chaos features and sharded ranks through
them; and the LM stack and TMSN-SGD (a bf16 backward that repeats bit
for bit, the engine equal to the oracle), and the serving tier (in-place
decode bit for bit the out-of-place one, a server run with admission
and adoption equal to the CPU's). Imports no JAX,
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
