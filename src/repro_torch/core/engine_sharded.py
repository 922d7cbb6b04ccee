"""The TMSN round engine sharded over a 1-D ``("workers",)`` or a
two-tier ``("pod", "workers")`` mesh of ``torch.distributed`` ranks;
counterpart of ``src/repro/core/engine_sharded.py``.

Every rank is a process that advances only its ``W_local = W / n_dev``
workers, rows ``[rank * W_local, (rank + 1) * W_local)``, and the ranks
exchange "something new" with one collective a round
(:func:`repro_torch.launch.mesh.all_gather_tree`), as the paper's
independent machines do. Relative to the single-device engine:

  * the in-flight state is destination-sharded and source-global: a
    ``(W_local, W, D)`` slice of the dense buffer, or ``(W_local, C)``
    pending queues, so delivery (kernel K2 on the queues) stays local;
  * dense gossip gathers every worker's certificate, broadcast flag and
    model payload; gated gossip (``gossip_mode="gated"``) gathers the
    certificates and flags of every worker but the payloads of only
    each rank's top-``gossip_top_k`` improvers; the sparse control plane
    (``control_plane="sparse"``) gathers only each rank's top-k
    ``(cert, global id)`` candidates, merged into the queues by kernel
    K3, so ``n_dev * k`` candidates reach every destination where one
    device offers ``k``;
  * the ``(D, W)`` snapshot ring is replicated on every rank and fed by
    the gathered payloads (scattered by global id under gated gossip);
  * on a pod mesh the round's gather runs over the rank's pod only
    (``WorkerMesh.intra``, a process subgroup: tier 1); under dense
    control the pod's ``(W_pod,)`` certificates and flags are scattered
    into ``(W,)``-wide arrays at the pod's block
    ``[p * W_pod, (p + 1) * W_pod)``. Improvements also
    collect in the pending mask ``EngineState.xpend``, and every
    ``cross_pod_every_k`` rounds (a host ``if`` on the round number, the
    same on every rank) each rank offers its top-``cross_pod_top_k``
    pending candidates — certificate, global id, payload — in one gather
    over the world (tier 2, pod-major). Receivers write the payloads into
    their ring and push only cross-pod sources (same-pod destinations
    heard tier 1), through K3 under sparse control; those pushes count
    in ``sent`` and in ``sent_dcn``. Each rank's ring is its pod's
    replica (the reference's ``n_pods * D`` rows sharded over ``pod``
    are one SPMD program's way of holding the same thing). At
    ``cross_pod_every_k = 1`` under uniform delay the pod engine gives
    the flat engine's certificates, history and adoptions bit for bit;
    at k > 1 it is a measured approximation;
  * the worker's per-round scan (kernel K1 through the scanner) runs on
    each rank over its own rows: one launch per rank per round;
  * counters are per-rank partials, gathered once at the end of the run
    and reduced by ``TrafficCounters.from_shards``; each rank keeps its
    own history and the ranks merge it at the end by (round, global
    worker id); a target stop is one ``all_reduce`` a round, and only
    with a target set; the publisher exports the best row from the rank
    that holds it. Every rank returns the same :class:`SimResult`.

Every rank issues the same collectives in the same order every round;
the data-dependent skips (no taker, no resample) are rank-local and
issue none.

Equivalence: the per-worker math is elementwise over the worker axis and
the delivery argmins run over the full source axis, so dense gossip with
dense control gives the single-device engine's run bit for bit,
counters included. Gated gossip and the sparse control plane give its
certificates, history and adoptions bit for bit under uniform delay
(the reference's suppressed-runner-up argument), while pushing
different numbers of messages by design.

Worker contract addition, as in the reference: a worker's methods see
local shards (leading axis ``W_local``), so every per-worker constant
(stream ids, feature masks, worker ids in payloads) lives in the state
pytree, which ``init_batch(W, seed)`` builds for all W workers and the
engine slices; no worker may derive a global identity from a leaf's
leading dimension.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.engine import (
    _COUNTERS,
    EngineConfig,
    EngineState,
    TMSNEngine,
    _Advanced,
    _i32,
    _inf,
    _Rows,
    _snap_ring,
)
from repro_torch.core.worker import BatchedTMSNWorker, export_payload_rows, tree_map
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    WorkerMesh,
    all_gather_object,
    all_gather_tree,
    all_reduce,
    broadcast_tree,
)


class ShardedTMSNEngine(TMSNEngine):
    """Round-based TMSN run over a 1-D ``("workers",)`` mesh, or two-tier
    over a ``("pod", "workers")`` mesh: this rank's share of it. Every
    rank of the mesh constructs the engine with the same worker and
    config and calls :meth:`run` together.

    ``device`` defaults to the mesh's device and must be it; the
    worker's tensors must live there too."""

    def __init__(
        self,
        worker: BatchedTMSNWorker,
        config: EngineConfig,
        device: str | torch.device | None = None,
    ) -> None:
        mesh = config.mesh
        if mesh is None:
            raise ValueError("ShardedTMSNEngine needs EngineConfig.mesh")
        names = tuple(mesh.axis_names)
        if names not in (("workers",), ("pod", "workers")):
            raise ValueError(
                "engine mesh must have axes ('workers',) or ('pod', 'workers'), "
                f"got {names}"
            )
        if not isinstance(mesh, WorkerMesh):
            raise ValueError(
                f"ShardedTMSNEngine needs a repro_torch.launch.mesh.WorkerMesh, got {type(mesh).__name__}"
            )
        self._mesh = mesh
        self._n_dev = mesh.size
        self._n_pods = mesh.pods
        self._wpp = mesh.shape["workers"]  # ranks a pod
        if config.n_workers % self._n_dev:
            raise ValueError(f"n_workers={config.n_workers} must divide over {self._n_dev} devices")
        self._w_local = config.n_workers // self._n_dev
        self._w_pod = config.n_workers // self._n_pods  # workers tier 1 gathers
        dev = mesh.device if device is None else resolve_device(device)
        if dev != mesh.device:
            raise ValueError(f"device {dev} is not the mesh rank's device {mesh.device}")
        super().__init__(worker, config, dev)
        lo = mesh.rank * self._w_local
        self._lo = lo
        # the reference's _ShardConsts: every per-worker constant sliced to
        # this rank's rows (delay as [local dst, src])
        self._rows = _Rows(*(a[lo : lo + self._w_local].contiguous() for a in self._rows))
        if self._n_pods > 1:
            # realizes the FaultPlan partition window (cross-pod edges)
            self._pod_of = self._all_ids // self._w_pod

    # ----- traffic accounting (ref engine_sharded.py:334-382) -----------
    def _gossip_split(self) -> tuple[int, int]:
        p = self._payload_bytes
        ici_ctrl, dcn_ctrl = self._control_split()
        if self.config.gossip_mode == "gated":
            # control plane + k candidate payloads per rank of the pod;
            # under dense control each payload also carries its int32 id
            k = min(int(self.config.gossip_top_k), self._w_local)
            ici = ici_ctrl + self._wpp * k * (p + (0 if self._control_sparse else 4))
        else:
            # dense payloads: every pod worker's model, every round
            ici = ici_ctrl + self._w_pod * p
        if self._n_pods == 1:
            return ici, 0
        # cross-pod tier: top-k pending payloads per rank, gathered over
        # every rank each cross_pod_every_k rounds, amortized per round
        kx = min(int(self.config.cross_pod_top_k), self._w_local)
        return ici, (self._n_dev * kx * p) // int(self.config.cross_pod_every_k) + dcn_ctrl

    def _control_split(self) -> tuple[int, int]:
        """(ICI, DCN) control bytes per round. Dense control: f32
        certificate + flag per pod worker, every round (5 B each); sparse
        control: (cert, global id, round) triples for each pod rank's
        top-k candidates (12 B each), independent of W. The cross-pod
        tier ships cert + id per flush candidate under dense control
        (8 B) and the triple under sparse (12 B), amortized over
        ``cross_pod_every_k``."""
        if self._control_sparse:
            k = min(int(self.config.gossip_top_k), self._w_local)
            ici = self._wpp * k * 12
        else:
            ici = self._w_pod * 5
        if self._n_pods == 1:
            return ici, 0
        kx = min(int(self.config.cross_pod_top_k), self._w_local)
        per = 12 if self._control_sparse else 8
        return ici, (self._n_dev * kx * per) // int(self.config.cross_pod_every_k)

    def _gossip_mode(self) -> str:
        return self.config.gossip_mode

    # ----- where rows live ---------------------------------------------
    def _local_rows(self, tree):
        rows = slice(self._lo, self._lo + self._w_local)
        # clones: no later write to this rank's rows reaches the global init
        return tree_map(lambda a: a[rows].clone() if isinstance(a, torch.Tensor) else a[rows], tree)

    def _global_certs_alive(self, state: EngineState) -> tuple[np.ndarray, np.ndarray]:
        g = all_gather_tree(self._mesh, {"certs": state.certs, "alive": state.alive})
        return g["certs"].cpu().numpy(), g["alive"].cpu().numpy()

    def _export_row(self, state: EngineState, gid: int):
        owner, row = divmod(gid, self._w_local)
        # every rank exports a row of the same shapes; the owner's is sent
        rows = torch.tensor([row if owner == self._mesh.rank else 0], device=self.device)
        out = broadcast_tree(self._mesh, export_payload_rows(self.worker, state.worker, rows), owner)
        return tree_map(lambda a: a[0], out)

    def _any_rank(self, flag: bool) -> bool:
        return bool(all_reduce(self._mesh, flag, "any"))

    def _merge_history(self, parts: list) -> list:
        cols = [np.concatenate([np.full(len(g), r, np.int64) for r, _, g, _ in parts])]
        cols += [np.concatenate([p[i] for p in parts]) for i in (1, 2, 3)]
        blocks = all_gather_object(self._mesh, cols)
        rnd, clock, gid, cert = (np.concatenate([b[i] for b in blocks]) for i in range(4))
        order = np.lexsort((gid, rnd))  # (round, global worker id), as one device orders it
        return list(zip(clock[order].tolist(), gid[order].tolist(), cert[order].tolist()))

    def _final(self, state: EngineState) -> dict:
        g = all_gather_tree(self._mesh, {
            "certs": state.certs,
            "clock": state.clock,
            "models": self.worker.export_models(state.worker),
            **{k: getattr(state, k).reshape(1) for k in _COUNTERS},
        })
        out = {k: g[k].cpu().numpy() for k in ("certs", "clock", *_COUNTERS)}
        out["models"] = g["models"]
        return out

    # ----- the round ------------------------------------------------------
    def _round_step(self, state: EngineState):
        """Steps 1-3, tier 1, and on a pod mesh the pending mask and, every
        ``cross_pod_every_k`` rounds, the tier-2 flush (its pushes count
        in ``sent`` and ``sent_dcn``)."""
        adv = self._advance(state)
        inflight, ring, pushed = self._gossip(state, adv)
        if self._n_pods == 1:
            return self._next_state(state, adv, inflight, ring, pushed)
        xpend = state.xpend | adv.improved
        n_dcn = 0
        if state.round % int(self.config.cross_pod_every_k) == 0:
            inflight, ring, xpend, pushed_x = self._flush(state.round, adv, inflight, ring, xpend)
            n_dcn = pushed_x[0]
            pushed = self._merge_pushed(pushed, pushed_x)
        new_state, info = self._next_state(state, adv, inflight, ring, pushed)
        return new_state._replace(xpend=xpend, sent_dcn=state.sent_dcn + n_dcn), info

    # ----- tier 1: gossip inside the pod (ref engine_sharded.py:500-750) ---
    def _gossip(self, state: EngineState, adv: _Advanced):
        """Steps 4-5 on this rank's rows: ONE all_gather over the pod (the
        whole mesh on a 1-D one) of the round's certificates, flags and
        payloads (or of each rank's top-k candidates), the ring written
        from what arrived, and the pushes into this rank's destination
        rows."""
        cfg, w, r = self.config, self.config.n_workers, state.round
        certs, slot, gated = adv.certs, r % self._depth, cfg.gossip_mode == "gated"
        tier = self._mesh.intra
        base = self._mesh.pod * self._w_pod  # the pod's first global id
        if self._control_sparse or gated:
            k = min(int(cfg.gossip_top_k), self._w_local)
            rows, valid = self._top_k_candidates(adv.improved, certs, k)
            cand_ids = torch.where(valid, self._rows.ids[rows], _i32(w, certs))
        if self._control_sparse:
            # the (wpp * k,) candidate triples, with their payloads
            # (gated) or every pod worker's model (dense payload plane)
            payload = (export_payload_rows(self.worker, adv.wstate, rows) if gated
                       else self.worker.export_models(adv.wstate))
            g = all_gather_tree(tier, {
                "certs": torch.where(valid, certs[rows], _inf(certs)), "ids": cand_ids, "models": payload,
            })
            ok = g["ids"] < w  # padding carries id W
            gids = g["ids"][ok].long()
            # only candidates are ever read back from the ring
            with trace.span("engine.ring"):
                ring = _scatter_ring(state.ring, g["models"], slot, gids, ok if gated else gids - base)
            with trace.span("engine.gossip"):
                inflight, *pushed = self._push_candidates(adv.inflight, g["certs"], g["ids"], adv, r)
            return inflight, ring, pushed
        if gated:
            # every pod worker's certificate and flag; the payloads of
            # each rank's top-k improvers only, scattered by global id
            bcast = torch.zeros(certs.shape, dtype=torch.bool, device=self.device)
            bcast[rows] = valid
            g = all_gather_tree(tier, {
                "certs": certs, "bcast": bcast, "ids": cand_ids,
                "models": export_payload_rows(self.worker, adv.wstate, rows),
            })
            ok = g["ids"] < w
            with trace.span("engine.ring"):
                ring = _scatter_ring(state.ring, g["models"], slot, g["ids"][ok].long(), ok)
        else:
            g = all_gather_tree(tier, {
                "certs": certs, "bcast": adv.improved, "models": self.worker.export_models(adv.wstate),
            })
            with trace.span("engine.ring"):
                ring = _snap_ring(state.ring, g["models"], slot, g["bcast"], base)
        certs_all, bcast_all = g["certs"], g["bcast"]
        if self._n_pods > 1:
            # the pod's (W_pod,) control plane at its block of (W,)
            certs_all = torch.full((w,), float("inf"), dtype=torch.float32, device=self.device)
            certs_all[base : base + self._w_pod] = g["certs"]
            bcast_all = torch.zeros((w,), dtype=torch.bool, device=self.device)
            bcast_all[base : base + self._w_pod] = g["bcast"]
        with trace.span("engine.gossip"):
            inflight, *pushed = self._push_broadcast(adv.inflight, certs_all, bcast_all, adv, r)
        return inflight, ring, pushed

    # ----- tier 2: the cross-pod flush (ref engine_sharded.py:752-927) ----
    def _flush(self, r: int, adv: _Advanced, inflight, ring, xpend):
        """Each rank's top-``cross_pod_top_k`` pending candidates,
        gathered over the whole mesh in pod-major order (a rank with none
        pending sends padding, id W); their payloads into the ring, their
        certificates pushed to this rank's rows from cross-pod sources
        only. Returns ``(inflight, ring, xpend, counters)``, the pending
        mask cleared where a candidate left."""
        cfg, w, certs = self.config, self.config.n_workers, adv.certs
        kx = min(int(cfg.cross_pod_top_k), self._w_local)
        rows, valid = self._top_k_candidates(xpend, certs, kx)
        g = all_gather_tree(self._mesh, {
            "certs": certs[rows], "ids": torch.where(valid, self._rows.ids[rows], _i32(w, certs)),
            "models": export_payload_rows(self.worker, adv.wstate, rows),
        })
        ok = g["ids"] < w
        ring = _scatter_ring(ring, g["models"], r % self._depth, g["ids"][ok].long(), ok)
        flushed = torch.zeros(xpend.shape, dtype=torch.bool, device=self.device)
        flushed[rows] = valid
        # only sources of another pod: same-pod destinations heard tier 1
        cross = ok & (torch.clamp(g["ids"], 0, w - 1) // self._w_pod != self._mesh.pod)
        if self._control_sparse:
            inflight, *pushed = self._push_candidates(
                inflight, torch.where(cross, g["certs"], _inf(certs)),
                torch.where(cross, g["ids"], _i32(w, certs)), adv, r,
            )
        else:
            ids = g["ids"][cross].long()
            xcerts = torch.full((w,), float("inf"), dtype=torch.float32, device=self.device)
            xcerts[ids] = g["certs"][cross]
            xbcast = torch.zeros((w,), dtype=torch.bool, device=self.device)
            xbcast[ids] = True
            inflight, *pushed = self._push_broadcast(inflight, xcerts, xbcast, adv, r)
        return inflight, ring, xpend & ~flushed, pushed


def _scatter_ring(ring, models, slot: int, gids: torch.Tensor, src):
    """Write ``models[src]`` (a row mask or index into the gathered
    leaves) into ring slot ``slot`` at global ids ``gids``."""

    def scat(buf: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        out = buf.clone()
        rows = m[src]
        out[slot, gids] = rows
        # the clone reads and writes the ring; the rows are gathered into a
        # temporary, which the assignment reads and writes into the slot
        trace.count("engine.copy_bytes", (2 * buf.numel() + 4 * rows.numel()) * buf.element_size(), "ring")
        return out

    return tree_map(scat, ring, models)


def sharded_engine_available(min_devices: int = 2) -> bool:
    """True when this process is a rank of an initialized
    ``torch.distributed`` world of at least ``min_devices`` ranks (the
    reference counts visible devices; here a shard is a rank)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() >= min_devices


__all__ = ["ShardedTMSNEngine", "sharded_engine_available"]
