"""Always-on serving tier: continuous batching over the live TMSN
ensemble, with zero-downtime model adoption; counterpart of
``src/repro/launch/serving.py``.

The paper's core move — broadcast only on improvement, never block —
applied to the train->serve edge:

  * :class:`AdoptionSlot` is the hand-off point. The engine publishes
    best-certificate snapshots (:meth:`repro_torch.core.engine.TMSNEngine.attach_publisher`)
    into a double-buffered slot, write-then-flip: the writer fills the
    inactive buffer and flips the version counter last, and a reader
    re-checks the version after taking the buffer, so a reader can see a
    stale snapshot (by at most the publish cadence) but never a torn one.
  * :class:`ContinuousServer` is a request-driven serving loop with a
    slot-based continuous batcher: a fixed (slots, max_len) cache is
    allocated at the start of a run; finished sequences free their row
    and queued requests claim it between decode steps (single-row
    prefill + cache insert). Each row decodes at its own position — the
    (b,) ``pos`` vector threaded through :func:`repro_torch.models.decode_step`.
  * Adoption happens between decode steps. A snapshot whose leaves have
    the server's shapes and dtypes is copied into the server's own
    parameter tensors (``copy_``): nothing is allocated, no pointer
    changes, no request is dropped.

Eager PyTorch has no jit cache, so :meth:`ContinuousServer.compile_counts`
counts, for each entry point (prefill, decode, insert), the distinct
input signatures it was called with (shape, dtype and device of every
tensor argument): what the reference's jit cache sizes count. After
:meth:`~ContinuousServer.warmup` they are prefill 2, decode 1, insert 1,
and admission and adoption add none.

The caches are the server's own and are written in place (the
reference donates them, ``donate_argnums=(2,)``): the decode step
writes each new K/V entry into its slot of the stacked buffers, and an
admitted request's prefix is a slice assignment into its row. The
server runs on the card (``device="cuda"``) unless the caller asks for
the CPU, and raises without a card. Every decoder-only family: GQA K/V
(full or a sliding window's ring), MLA latents and SSD state; the
reference's cross-attention and frontend branches raise (ROADMAP.md
queue 1, item 14b).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.data.tokens import _mix64
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import init_cache
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import check_supported
from repro_torch.tree import tree_leaves, tree_map


# ----------------------------------------------------------------------------
# cache re-buffering: prompt-sized prefill caches -> max_len decode buffers
# ----------------------------------------------------------------------------


def _prefix(b_full: torch.Tensor, b_pre: torch.Tensor) -> tuple[tuple, torch.Tensor]:
    """Where a prefill cache entry lands in its decode buffer, batch rows
    aside: (the index of dims 2.., the block to write). SSD state and
    conv tails have the buffer's shape there and land whole; K/V and MLA
    latents are a prompt prefix along dim 2. A prompt longer than a
    sliding window's ring (``windowed_cache``) keeps its last S
    positions, each at slot ``position % S``, as decode writes them."""
    S, n = b_full.shape[2], b_pre.shape[2]
    if n > S:
        b_pre = torch.roll(b_pre[:, :, n - S:], shifts=n % S, dims=2)
    return tuple(slice(0, m) for m in b_pre.shape[2:]), b_pre


def rebuffer_caches(cfg, prefill_caches, batch: int, max_len: int, prompt_len: int, enc_len: int):
    """Copy prefill caches (sized to the prompt) into zeroed max_len
    buffers on the prefill caches' device: SSD state and conv tails
    whole (the reference's ``serving.py:61``), each self-attention K/V
    and MLA latent cache the prompt prefix along its sequence axis, and
    a sliding window's ring (``cfg.windowed_cache``) the prompt's last
    window positions at their ring slots. ``enc_len`` (the
    cross-attention length) is 0 for every model the port has."""
    check_supported(cfg)  # cross-attention K/V and frontends: item 14b
    full = init_cache(cfg, batch, max_len, device=tree_leaves(prefill_caches)[0].device)
    for seg_full, seg_pre in zip(full, prefill_caches):
        for buf_full, buf_pre in zip(seg_full, seg_pre):
            for b_full, b_pre in zip(buf_full, buf_pre):
                idx, block = _prefix(b_full, b_pre)
                b_full[(slice(None), slice(None)) + idx].copy_(block)
    return full


def _insert_row(caches, pre_caches, row: int):
    """Write a single prefilled request (batch-1 prefill caches) into
    row ``row`` of the full decode buffers, in place; returns them.

    The batch-1 block lands at (0, row, 0, ...): a full row overwrite
    for SSD state and conv tails (their shapes match but for the batch)
    and a prompt-prefix write for self-attention K/V and MLA latents (the
    pre block is shorter along the seq axis; a ring keeps the last
    window, as :func:`rebuffer_caches` does). Stale entries beyond the
    prefix belong to the row's previous occupant and sit at key
    positions > the new request's positions, so the causal mask hides
    them until they are overwritten.
    """

    def one(b_full, b_pre):
        idx, block = _prefix(b_full, b_pre)
        b_full[(slice(None), slice(row, row + 1)) + idx].copy_(block)
        return b_full

    return tree_map(one, caches, pre_caches)


# ----------------------------------------------------------------------------
# the adoption slot
# ----------------------------------------------------------------------------


class Snapshot(NamedTuple):
    """One published model: the params pytree plus its provenance."""

    version: int  # publish counter, 1-based; monotonically increasing
    params: Any  # host-side params pytree (CPU tensors from the engine)
    cert: float  # the certificate the snapshot was published at
    round: int  # engine round the snapshot was exported at


class AdoptionSlot:
    """Double-buffered single-slot snapshot exchange (write-then-flip).
    Writers are serialized by a lock; readers never take it."""

    def __init__(self) -> None:
        self._buffers: list[tuple[Any, float, int] | None] = [None, None]
        self._version = 0  # 0 = nothing published yet
        self._write_lock = threading.Lock()
        self.publishes = 0

    @property
    def version(self) -> int:
        """Latest published version (a cheap staleness probe)."""
        return self._version

    @property
    def latest_cert(self) -> float:
        """Certificate of the freshest snapshot (nan before the first)."""
        snap = self.acquire()
        return float("nan") if snap is None else snap.cert

    def publish(self, params: Any, cert: float, round: int = 0) -> int:
        """Write-then-flip. Returns the new version."""
        with self._write_lock:
            v = self._version + 1
            # buffer v % 2 is inactive while version == v - 1: readers
            # are pointed at (v - 1) % 2
            self._buffers[v % 2] = (params, float(cert), int(round))
            self._version = v  # flip last: the publication point
            self.publishes += 1
            return v

    def acquire(self) -> Snapshot | None:
        """Latest snapshot, or None before the first publish. Never
        torn: the version is re-checked after the buffer read and the
        read retries if a flip raced it."""
        while True:
            v0 = self._version
            if v0 == 0:
                return None
            buf = self._buffers[v0 % 2]
            if self._version == v0:
                params, cert, rnd = buf
                return Snapshot(v0, params, cert, rnd)


# ----------------------------------------------------------------------------
# requests
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One generation request. ``prompt`` must be (prompt_len,) int —
    the batcher keeps fixed shapes, so all requests share the server's
    prompt length. ``max_new`` counts generated tokens *including* the
    prefill-produced first token; it must be in [1, cfg.max_new]. (The
    reference's ``frontend`` embeddings come with item 14b's models.)"""

    rid: int
    prompt: np.ndarray
    max_new: int


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray  # (n_generated,) int32, prefill token first
    latency_s: float  # queue entry -> last token
    versions: tuple[int, ...]  # snapshot versions this request decoded under


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Continuous-batcher shape and sampling policy. All shapes are
    fixed at construction — admission and adoption add no signature."""

    slots: int  # concurrent sequences (the fixed batch dimension)
    prompt_len: int
    max_new: int  # per-request cap; sets max_len = prompt_len + max_new
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    #: check the adoption slot every N decode steps (1 = every step);
    #: larger values trade staleness for fewer host version probes
    adopt_every: int = 1

    def __post_init__(self) -> None:
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {self.prompt_len}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.adopt_every < 1:
            raise ValueError(f"adopt_every must be >= 1, got {self.adopt_every}")
        if not self.greedy and not self.temperature > 0.0:
            raise ValueError(
                f"temperature must be > 0 for sampling, got {self.temperature}"
            )


# ----------------------------------------------------------------------------
# the server
# ----------------------------------------------------------------------------


def _signature(*trees) -> tuple:
    """Shape, dtype and device of every tensor leaf (the type of any
    other leaf): what a jit cache keys a call on."""
    return tuple((tuple(a.shape), a.dtype, a.device) if isinstance(a, torch.Tensor) else type(a).__name__
                 for t in trees for a in tree_leaves(t))


def _same_layout(dst: Any, src: Any) -> bool:
    """Does ``src`` have ``dst``'s tree, and each leaf its shape and dtype?"""
    try:
        fits = tree_leaves(tree_map(
            lambda d, s: isinstance(s, torch.Tensor) and d.shape == s.shape and d.dtype == s.dtype, dst, src))
    except (KeyError, TypeError):
        return False
    return len(fits) == len(tree_leaves(src)) and all(fits)


class ContinuousServer:
    """Slot-based continuous batcher over fixed-shape decode buffers.

    Two entry points, both warmed once by :meth:`warmup`:

      * prefill — at (slots, prompt_len) for the batched bootstrap and
        at (1, prompt_len) for mid-run admission;
      * decode — at (slots,) per-row positions, params passed as an
        argument so adoption is a pure data swap.

    ``params`` is a pytree of tensors. Tensors already on ``device``
    become the server's own as they are (as ``jax.device_put`` takes
    them: no second copy of a large model), and an adoption writes into
    them: the caller hands them over, so pass a copy to keep yours.
    Tensors elsewhere are copied to ``device``.

    Sampling draws ``(slots, padded_vocab)`` Gumbel noise for decode
    step ``i`` from a generator on ``device`` seeded by ``(seed, i)``
    (``-log(-log(u))``, ``u`` uniform on ``[tiny, 1)`` as ``jax.random.gumbel``
    draws it). ``noise(i)`` replaces that draw, so a test can inject the
    reference's ``jax.random.gumbel(fold_in(PRNGKey(seed), i), ...)``.

    A no-publish run (``slot=None``, all requests admitted at start,
    equal lengths) decodes in lockstep — every row of the (b,) position
    vector equal — and is bit-identical to the legacy scalar-``pos``
    serve loop (pinned in tests/test_torch_serving.py).
    """

    def __init__(self, cfg: ArchConfig, scfg: ServingConfig, params: Any, device: str | torch.device = "cuda",
                 noise: Callable[[int], torch.Tensor] | None = None) -> None:
        check_supported(cfg)
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda a: a.detach().to(self.device), params)
        self.max_len = scfg.prompt_len + scfg.max_new
        self._prefill_fn = make_prefill_step(cfg)
        self._decode_fn = make_decode_step(cfg, greedy=scfg.greedy, temperature=scfg.temperature)
        self._noise = noise
        self._gen = torch.Generator(device=self.device)
        self._sigs: dict[str, set] = {"prefill": set(), "decode": set(), "insert": set()}
        self.adopted_version = 0  # 0 = serving the constructor params
        self.served_cert = float("nan")
        self.adoptions = 0
        self._warmed = False

    # -- plumbing -----------------------------------------------------------

    def _batchify(self, prompts: list[np.ndarray]) -> dict:
        toks = torch.from_numpy(np.stack(prompts).astype(np.int32)).to(self.device)
        return {"tokens": toks, "labels": toks, "mask": torch.ones(toks.shape, dtype=torch.float32,
                                                                   device=self.device)}

    def _prefill(self, params, batch):
        self._sigs["prefill"].add(_signature(params, batch))
        return self._prefill_fn(params, batch)

    def _decode(self, params, token, caches, pos, gumbel):
        self._sigs["decode"].add(_signature(params, token, caches, pos, gumbel))
        return self._decode_fn(params, token, caches, pos, gumbel)

    def _insert(self, caches, pre_caches, row: int):
        self._sigs["insert"].add(_signature(caches, pre_caches))
        return _insert_row(caches, pre_caches, row)

    def _gumbel(self, step: int) -> torch.Tensor | None:
        """Decode step ``step``'s sampling noise (None when greedy)."""
        if self.scfg.greedy:
            return None
        if self._noise is not None:
            return self._noise(step).to(self.device)
        self._gen.manual_seed(_mix64(((self.scfg.seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)))
        shape = (self.scfg.slots, self.cfg.padded_vocab())
        u = torch.rand(shape, generator=self._gen, device=self.device).clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def compile_counts(self) -> dict[str, int]:
        """Distinct input signatures of the serving-path entry points —
        the no-recompile-after-warmup assertion reads these."""
        return {name: len(sigs) for name, sigs in self._sigs.items()}

    def warmup(self) -> float:
        """Run every serving-path entry point once on dummy inputs;
        returns the wall time spent (reported as ``compile_s``). Idempotent."""
        t0 = time.perf_counter()
        B, P = self.scfg.slots, self.scfg.prompt_len
        zeros = [np.zeros(P, np.int32) for _ in range(B)]
        tok, pre = self._prefill(self.params, self._batchify(zeros))
        caches = rebuffer_caches(self.cfg, pre, B, self.max_len, P, 0)
        _, pre1 = self._prefill(self.params, self._batchify(zeros[:1]))
        caches = self._insert(caches, pre1, 0)
        pos = torch.from_numpy(np.full((B,), P, np.int32)).to(self.device)
        tok, caches = self._decode(self.params, tok, caches, pos, self._gumbel(0))
        tok.cpu()  # waits for the device
        self._warmed = True
        return time.perf_counter() - t0

    def adopt(self, slot: AdoptionSlot) -> bool:
        """Adopt the newest published snapshot if it is fresher than
        the one being served. Returns True on an actual swap."""
        if slot.version == self.adopted_version:
            return False
        snap = slot.acquire()
        if snap is None or snap.version == self.adopted_version:
            return False
        if _same_layout(self.params, snap.params):
            with torch.no_grad():  # a data swap into the server's own tensors
                tree_map(lambda dst, src: dst.copy_(src), self.params, snap.params)
        else:  # another layout: new tensors, a new signature (a retrace)
            self.params = tree_map(lambda a: a.detach().to(self.device, copy=True), snap.params)
        self.adopted_version = snap.version
        self.served_cert = snap.cert
        self.adoptions += 1
        return True

    # -- the loop -----------------------------------------------------------

    def run(
        self,
        requests: list[Request],
        slot: AdoptionSlot | None = None,
        step_hook: Callable[["ContinuousServer", int], None] | None = None,
    ) -> tuple[list[RequestResult], dict]:
        """Serve ``requests`` to completion. All requests are queued at
        t=0; admission is continuous (freed slots are re-claimed between
        decode steps). Returns (results sorted by rid, metrics)."""
        scfg = self.scfg
        B, P = scfg.slots, scfg.prompt_len
        for r in requests:
            if not 1 <= r.max_new <= scfg.max_new:
                raise ValueError(
                    f"request {r.rid}: max_new must be in [1, {scfg.max_new}], "
                    f"got {r.max_new}"
                )
            if np.shape(r.prompt) != (P,):
                raise ValueError(
                    f"request {r.rid}: prompt must be ({P},), got {np.shape(r.prompt)}"
                )
        counts0 = self.compile_counts() if self._warmed else None
        pending = deque(requests)
        results: list[RequestResult] = []

        active = [False] * B
        req_of: list[Request | None] = [None] * B
        toks: list[list[int]] = [[] for _ in range(B)]
        versions: list[set[int]] = [set() for _ in range(B)]
        pos_h = np.zeros((B,), np.int32)
        tok_h = np.zeros((B, 1), np.int32)

        step_wall: list[float] = []
        adoption_steps: list[int] = []
        cert_gaps: list[float] = []
        prefill_s = 0.0

        t_run0 = time.perf_counter()

        def retire(s: int) -> None:
            req = req_of[s]
            results.append(
                RequestResult(
                    rid=req.rid,
                    tokens=np.asarray(toks[s], np.int32),
                    latency_s=time.perf_counter() - t_run0,
                    versions=tuple(sorted(versions[s])),
                )
            )
            active[s] = False
            req_of[s] = None

        def bookkeep_admit(s: int, req: Request, first_tok: int) -> None:
            active[s] = True
            req_of[s] = req
            toks[s] = [first_tok]
            versions[s] = {self.adopted_version}
            pos_h[s] = P
            tok_h[s, 0] = first_tok
            if len(toks[s]) >= req.max_new:
                retire(s)

        # batched bootstrap: a full first wave prefills in one call —
        # the same batched-prefill + rebuffer path as the legacy serve
        t0 = time.perf_counter()
        if len(pending) >= B:
            wave = [pending.popleft() for _ in range(B)]
            ntok, pre = self._prefill(self.params, self._batchify([r.prompt for r in wave]))
            caches = rebuffer_caches(self.cfg, pre, B, self.max_len, P, 0)
            ntok_h = ntok.cpu().numpy()
            for s, r in enumerate(wave):
                bookkeep_admit(s, r, int(ntok_h[s, 0]))
        else:
            caches = init_cache(self.cfg, B, self.max_len, device=self.device)
        prefill_s += time.perf_counter() - t0

        step = 0
        while True:
            # admission: freed slots claim queued requests (single-row
            # prefill + in-place cache insert; fixed shapes throughout)
            for s in range(B):
                while not active[s] and pending:
                    req = pending.popleft()
                    t0 = time.perf_counter()
                    ntok1, pre1 = self._prefill(self.params, self._batchify([req.prompt]))
                    caches = self._insert(caches, pre1, s)
                    prefill_s += time.perf_counter() - t0
                    bookkeep_admit(s, req, int(ntok1[0, 0]))
            if not any(active):
                break

            # adoption between decode steps: a cheap version probe, then
            # a torn-read-safe acquire only when the slot moved. The
            # step's clock starts first: the reference's device_put
            # returns before its transfer and its decode step absorbs it,
            # where copy_ from host memory returns after the copy
            t0 = time.perf_counter()
            adopted = False
            if slot is not None and step % scfg.adopt_every == 0:
                adopted = self.adopt(slot)
            if slot is not None:
                fresh = slot.latest_cert
                if np.isfinite(self.served_cert) and np.isfinite(fresh):
                    cert_gaps.append(self.served_cert - fresh)

            tok_d, caches = self._decode(
                self.params, torch.from_numpy(tok_h).to(self.device), caches,
                torch.from_numpy(pos_h).to(self.device), self._gumbel(step),
            )
            # host sync: completions are decided here (a copy — admission
            # writes fresh first-tokens into freed rows)
            tok_h = tok_d.cpu().numpy().copy()
            step_wall.append(time.perf_counter() - t0)
            if adopted:
                adoption_steps.append(step)

            for s in range(B):
                if not active[s]:
                    continue
                toks[s].append(int(tok_h[s, 0]))
                versions[s].add(self.adopted_version)
                pos_h[s] += 1
                if len(toks[s]) >= req_of[s].max_new:
                    retire(s)
            step += 1
            if step_hook is not None:
                step_hook(self, step)

        wall_s = time.perf_counter() - t_run0
        results.sort(key=lambda r: r.rid)
        decode_tok = sum(len(r.tokens) - 1 for r in results)
        latencies = np.asarray([r.latency_s for r in results] or [0.0])
        walls_ms = np.asarray(step_wall or [0.0]) * 1e3
        adopt_ms = np.asarray([step_wall[i] for i in adoption_steps] or [0.0]) * 1e3
        steady = [w for i, w in enumerate(step_wall) if i not in set(adoption_steps)]
        steady_ms = np.asarray(steady or [0.0]) * 1e3
        counts1 = self.compile_counts()
        metrics = {
            "wall_s": wall_s,
            "requests_completed": len(results),
            "dropped_requests": len(requests) - len(results),
            "req_per_s": len(results) / max(wall_s, 1e-9),
            "latency_p50_s": float(np.percentile(latencies, 50)),
            "latency_p99_s": float(np.percentile(latencies, 99)),
            "decode_steps": step,
            "decode_tokens": decode_tok,
            "prefill_s": prefill_s,
            "decode_s": float(np.sum(step_wall)),
            "decode_tok_per_s": decode_tok / max(float(np.sum(step_wall)), 1e-9),
            "step_p50_ms": float(np.percentile(walls_ms, 50)),
            "step_p99_ms": float(np.percentile(walls_ms, 99)),
            "adoptions": self.adoptions,
            "adoption_steps": list(adoption_steps),
            "adoption_blip_p99_ms": float(np.percentile(adopt_ms, 99)),
            "steady_step_p99_ms": float(np.percentile(steady_ms, 99)),
            "stale_cert_gap_mean": float(np.mean(cert_gaps)) if cert_gaps else 0.0,
            "stale_cert_gap_max": float(np.max(cert_gaps)) if cert_gaps else 0.0,
            "recompiles": (
                sum(counts1.values()) - sum(counts0.values())
                if counts0 is not None
                else None
            ),
        }
        return results, metrics
