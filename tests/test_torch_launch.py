"""The port's launch tooling held against the JAX package on the CPU:
``repro_torch.checkpoint``, ``launch/mesh.py``'s production meshes,
``launch/sharding.py``, the legacy barrier round of
``core/tmsn_sgd.py``, ``launch/train.py``, ``launch/analytic.py``,
``launch/hlo_analysis.py`` and ``launch/dryrun.py``.

  * Checkpoints the JAX package writes (``repro.checkpoint``) load into
    the port bit for bit — reduced() params of five families, one in
    bfloat16, and an AdamW state with bfloat16 moments — and the port's
    own file has the reference's keys, ``dtype.str`` and bytes; the
    reference's ``TestCheckpoint`` mirrored.
  * Every spec rule equals the reference's element for element for every
    architecture at full size (shapes only: ``jax.eval_shape`` beside
    ``device="meta"``); the port's cache layout is the reference's leaf
    for leaf, so the cache rules see the same shapes. A hypothesis port
    of ``test_fit_spec_always_valid``, with the reference's ``fit_spec``
    beside it. One gloo world of 4 CPU ranks lays reduced() params out
    with ``fit_sharding_tree`` over ``(data=2, model=2)`` and a batch over
    ``(pod=2, data=2)``: each local shard is the block JAX's layout gives
    that rank, and ``full_tensor()`` gives back the same bits.
  * The legacy round against ``repro.core.tmsn_sgd.make_tmsn_round`` at
    reduced(yi-9b), W = 2, K = 2, one and two rounds, from the sentinel
    certificates and from finite ones, at eps 0 and +-1e9 (the
    reference's ``test_adoption_copies_winner``): certificates and losses
    at rtol 1e-5, params and moments at rtol 1e-4 / atol 1e-5 (the
    tolerances of tests/test_torch_sgd.py), adoptions and steps exact.
  * ``train_sync`` and ``train_tmsn`` with the reference's batches and
    initial params against a loop of the reference's jitted step and
    round.
  * ``step_counts`` and ``active_param_fraction`` equal for every arch x
    shape; ``roofline`` equal; the dry-run's
    ``memory.argument_size_in_bytes`` equal to a sum taken from the
    reference's own specs and ``fit_spec``; no record is an error.
"""

import dataclasses
import functools
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.checkpoint.ckpt import _path_str as jpath  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import tmsn_sgd as jtmsn  # noqa: E402
from repro.data.tokens import synthetic_token_batch as jbatch  # noqa: E402
from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import sharding as jshard  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.dryrun import active_param_fraction as japf  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import apply_updates as japply  # noqa: E402
from repro.optim import init_opt_state as jinit_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.checkpoint.ckpt import _path_str  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import tmsn_sgd as ttmsn  # noqa: E402
from repro_torch.launch import analytic, dryrun, hlo_analysis, sharding, steps  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402

CPU = "cpu"
CERT = dict(rtol=1e-5, atol=0.0)
STATE = dict(rtol=1e-4, atol=1e-5)
MESHES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jflat(tree) -> dict:
    """Reference pytree -> {checkpoint key: leaf}, PartitionSpecs as leaves."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {jpath(k): v for k, v in flat}


def tflat(tree) -> dict:
    return {_path_str(k): v for k, v in tree_leaves_with_path(tree)}


def bits(a) -> np.ndarray:
    """A leaf's bytes as unsigned integers of its width (a port tensor or
    a numpy array, bfloat16 included)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


# ---------------------------------------------------------------------------
# checkpoint (src/repro/checkpoint/ckpt.py; tests/test_launch.py::TestCheckpoint)
# ---------------------------------------------------------------------------

#: reduced() families whose params the reference writes; the last in bfloat16
CKPT_ARCHS = ("yi_9b", "mamba2_1p3b", "zamba2_1p2b", "deepseek_v3_671b", "gemma3_12b:bfloat16")


@functools.cache
def _ref_tree(which: str):
    """The reference's tree for a case: reduced() params, or an AdamW
    state with bfloat16 moments after one step (built once a module)."""
    if which == "adamw":
        cfg, ocfg = jreduced(jget("yi-9b")), JAdamW(state_dtype="bfloat16")

        def one_step(key):
            params = jinit(cfg, key)
            grads = jax.tree_util.tree_map(lambda a: 0.01 * jnp.ones_like(a), params)
            return japply(params, grads, jinit_opt(params, ocfg), ocfg)[1]

        return jax.jit(one_step)(jax.random.PRNGKey(0))
    arch, _, dtype = which.partition(":")
    cfg = jreduced(jget(arch))
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    return jax.jit(lambda k: jinit(cfg, k))(jax.random.PRNGKey(0))  # jitted: 2.5x faster than eager here


def _port_like(ref):
    """The port's tree of the same structure, dtypes and shapes, zeros."""
    return tree_map(torch.zeros_like, convert.lm_params_from_numpy(np_tree(ref), CPU))


@pytest.mark.parametrize("which", CKPT_ARCHS + ("adamw",))
def test_jax_checkpoint_loads_bit_for_bit(tmp_path, which):
    """A file ``repro.checkpoint.save_checkpoint`` writes loads into the
    port's tree: every leaf the reference's bits, in the template's dtype
    (bfloat16 leaves arrive as the reference's ``|V2``)."""
    ref = _ref_tree(which)
    path = str(tmp_path / "ref.npz")
    jsave(path, ref)
    got = tflat(load_checkpoint(path, _port_like(ref)))
    want = jflat(ref)
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(bits(got[k]), bits(w), err_msg=k)
    if ":bfloat16" in which or which == "adamw":
        assert any(np.load(path)[k].dtype.str == "|V2" for k in want)


@pytest.mark.parametrize("which", CKPT_ARCHS + ("adamw",))
def test_port_checkpoint_matches_reference_file(tmp_path, which):
    """The port's file for the same (converted) tree has the reference's
    keys, ``dtype.str`` and bytes under each key."""
    ref = _ref_tree(which)
    jsave(str(tmp_path / "ref.npz"), ref)
    save_checkpoint(str(tmp_path / "port.npz"), convert.lm_params_from_numpy(np_tree(ref), CPU))
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype.str == b[k].dtype.str and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_checkpoint_roundtrip(tmp_path):
    """TestCheckpoint.test_roundtrip, on the port's own reduced Mamba2."""
    params = init_params(reduced(get_config("mamba2-1.3b")), 0, CPU)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, params)
    restored = load_checkpoint(path, tree_map(torch.zeros_like, params))
    for a, b in zip(tree_leaves(params), tree_leaves(restored)):
        assert torch.equal(a, b)


def test_checkpoint_shape_mismatch_and_missing_key_raise(tmp_path):
    """TestCheckpoint.test_shape_mismatch_raises, and the reference's
    KeyError for a key the file lacks."""
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"w": torch.ones((2,))})
    with pytest.raises(ValueError):
        load_checkpoint(path, {"w": torch.ones((3,))})
    with pytest.raises(KeyError):
        load_checkpoint(path, {"v": torch.ones((2,))})


def test_checkpoint_paths_and_casts_as_reference(tmp_path):
    """As ``repro.checkpoint``'s ``_path_str`` and ``load_checkpoint``:
    NamedTuple fields are ``.name``, ``None`` saves nothing, a path
    without ``.npz`` loads, and a float32 leaf loaded into a bfloat16
    template is the reference's cast bit for bit."""
    from typing import NamedTuple

    class Pair(NamedTuple):
        a: object
        b: object

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    tree = {"n": Pair(torch.from_numpy(x), None), "s": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(str(tmp_path / "p"), tree)
    with np.load(tmp_path / "p.npz") as f:
        assert sorted(f.files) == ["n/.a", "s"]
    like = {"n": Pair(torch.zeros((3, 5), dtype=torch.bfloat16), None), "s": torch.zeros((), dtype=torch.int32)}
    got = load_checkpoint(str(tmp_path / "p"), like)
    want = jload(str(tmp_path / "p"), {"n": Pair(jnp.zeros((3, 5), jnp.bfloat16), None), "s": jnp.int32(0)})
    assert got["n"].b is None and got["n"].a.dtype == torch.bfloat16 and int(got["s"]) == 3
    np.testing.assert_array_equal(bits(got["n"].a), bits(np.asarray(want["n"].a)))


# ---------------------------------------------------------------------------
# mesh (src/repro/launch/mesh.py) and sharding rules (src/repro/launch/sharding.py)
# ---------------------------------------------------------------------------


def test_production_meshes_are_descriptions():
    """``repro.launch.mesh.make_production_mesh`` / ``make_host_mesh`` /
    ``data_axes``: the reference's axes and sizes, built without a device
    or a world."""
    single, multi, host = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True), \
        tmesh.make_host_mesh()
    assert (single.axis_names, single.shape, single.size) == (("data", "model"), (16, 16), 256)
    assert (multi.axis_names, multi.shape, multi.size) == (("pod", "data", "model"), (2, 16, 16), 512)
    assert host.axis_sizes == {"data": 1, "model": 1}
    assert tmesh.data_axes(single) == ("data",) and tmesh.data_axes(multi) == ("pod", "data")
    with pytest.raises(RuntimeError):
        single.device_mesh("cpu")  # no world of 256 ranks here
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW) == (989e12, 3.35e12)


def test_fit_spec_drops_nondivisible():
    """TestShardingRules.test_fit_spec_drops_nondivisible."""
    P = sharding.P
    sizes = {"data": 16, "model": 16}
    assert sharding.fit_spec(P("model", "data"), (50280, 2048), sizes) == P(None, "data")
    assert sharding.fit_spec(P("data", "model"), (4096, 11008), sizes) == P("data", "model")
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert sharding.fit_spec(P(("pod", "data"), None), (32, 128), sizes) == P(("pod", "data"), None)
    assert sharding.fit_spec(P(("pod", "data"), None), (31, 128), sizes) == P(None, None)


def test_fit_spec_always_valid():
    """tests/test_properties.py::test_fit_spec_always_valid, with the
    reference's fit_spec beside the port's."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(deadline=None, max_examples=50)
    @hyp.given(st.lists(st.integers(min_value=1, max_value=8192), min_size=1, max_size=4),
               st.sampled_from([("data",), ("model",), ("data", "model"), (("pod", "data"), "model")]))
    def prop(shape, axes):
        sizes = {"data": 16, "model": 16, "pod": 2}
        parts = [axes[i % len(axes)] for i in range(len(shape))]
        fitted = sharding.fit_spec(sharding.P(*parts), tuple(shape), sizes)
        assert tuple(fitted) == tuple(jshard.fit_spec(JP(*parts), tuple(shape), sizes))
        for dim, part in zip(shape, tuple(fitted) + (None,) * len(shape)):
            if part is None:
                continue
            total = 1
            for a in part if isinstance(part, tuple) else (part,):
                total *= sizes[a]
            assert dim % total == 0

    prop()


def test_serve_mode_drops_fsdp_for_2d():
    """TestShardingRules.test_serve_mode_drops_fsdp_for_2d."""
    cfg = get_config("yi-9b")
    shapes = init_params(cfg, 0, device="meta")
    train = tree_leaves(sharding.param_pspecs(shapes, cfg, mode="train"))
    serve = tree_leaves(sharding.param_pspecs(shapes, cfg, mode="serve"))
    assert len(train) == len(tree_leaves(shapes)) and all(isinstance(s, sharding.P) for s in train)
    assert any("data" in tuple(x) for x in train)
    assert all("data" not in tuple(x) for x in serve)


@pytest.fixture(scope="module")
def ref_shapes():
    """arch -> the reference's params and decode caches by ``jax.eval_shape``."""
    out = {}
    for arch in ARCH_IDS:
        cfg = jget(arch)
        out[arch] = {"params": jax.eval_shape(lambda k, c=cfg: jinit(c, k), jax.random.PRNGKey(0)),
                     **{s: jsteps.decode_specs(cfg, s)["caches"] for s in ("decode_32k", "long_500k")}}
    return out


def _same_specs(got, want):
    got, want = tflat(got), jflat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], sharding.P), k
        assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(ref_shapes, arch):
    """param_pspecs (train, serve), opt_pspecs, batch_pspecs and
    cache_pspecs equal the reference's element for element at full size.
    The port's caches (``init_cache(..., device="meta")``) have the
    reference's layout leaf for leaf, so ``cache_pspecs``' rank and
    ``shape[2] >= 4096`` keys read the same shapes."""
    jcfg, tcfg = jget(arch), get_config(arch)
    jp, tp = ref_shapes[arch]["params"], init_params(tcfg, 0, device="meta")
    for mode in ("train", "serve"):
        _same_specs(sharding.param_pspecs(tp, tcfg, mode), jshard.param_pspecs(jp, jcfg, mode))
    _same_specs(sharding.opt_pspecs(sharding.param_pspecs(tp, tcfg)),
                jshard.opt_pspecs(jshard.param_pspecs(jp, jcfg)))
    for dp in (("data",), ("pod", "data")):
        for shape in ("train_4k", "prefill_32k"):
            for shard in (True, False):
                _same_specs(sharding.batch_pspecs(steps.batch_specs(tcfg, shape), dp, shard),
                            jshard.batch_pspecs(jsteps.batch_specs(jcfg, shape), dp, shard))
        for shape in ("decode_32k", "long_500k"):
            tc, jc = steps.decode_specs(tcfg, shape)["caches"], ref_shapes[arch][shape]
            assert [tuple(a.shape) for a in tree_leaves(tc)] == [tuple(a.shape) for a in jax.tree.leaves(jc)]
            for long_context in (False, True):
                _same_specs(sharding.cache_pspecs(tc, tcfg, dp, long_context),
                            jshard.cache_pspecs(jc, jcfg, dp, long_context))


def test_placements_follow_the_spec():
    """The layout ``jax.sharding.NamedSharding`` gives a spec, as DTensor
    placements: Shard(dim) on each mesh axis a spec names, Replicate
    elsewhere; a tuple splits a dim over its axes in the mesh's order only."""
    from torch.distributed.tensor import Replicate, Shard

    P, names = sharding.P, ("pod", "data", "model")
    assert sharding.placements(P(("pod", "data"), None, "model"), names) == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements(P(), names) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.placements(P(("data", "pod")), names)
    with pytest.raises(ValueError):
        sharding.placements(P("model", "model"), names)


#: the world's cases: (arch, mode) over (data=2, model=2)
WORLD_CASES = [(a, m) for a in ("yi_9b", "deepseek_v3_671b", "mamba2_1p3b") for m in ("train", "serve")]


def _block(full: torch.Tensor, spec, sizes: dict, coord: dict) -> torch.Tensor:
    """The block of ``full`` that JAX's layout of ``spec`` gives the device
    at mesh coordinate ``coord``: a dim over axes (a1, a2, ...) is split
    in prod(sizes) blocks, indexed major first."""
    out = full
    for dim, part in enumerate(spec):
        if part is None:
            continue
        idx, n = 0, 1
        for a in part if isinstance(part, tuple) else (part,):
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        step = full.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out


def _layout_checks(dmesh, specs_tree, tree) -> dict:
    from torch.distributed.tensor import distribute_tensor

    names = tuple(dmesh.mesh_dim_names)
    sizes = tmesh.axis_sizes(dmesh)
    coord = dict(zip(names, dmesh.get_coordinate()))
    out = {}
    for (path, leaf), sh in zip(tree_leaves_with_path(tree), tree_leaves(
            sharding.fit_sharding_tree(dmesh, specs_tree, tree))):
        dt = distribute_tensor(leaf, dmesh, list(sh.placements))
        local = dt.to_local()
        out[_path_str(path)] = dict(
            spec=tuple(sh.spec),
            local_shape_ok=tuple(local.shape) == tuple(
                s // sharding.shard_divisor(sharding.P(p), sizes) for s, p in
                zip(leaf.shape, tuple(sh.spec) + (None,) * (leaf.dim() - len(sh.spec)))),
            block_ok=torch.equal(local, _block(leaf, sh.spec, sizes, coord)),
            full_ok=bool(np.array_equal(bits(dt.full_tensor()), bits(leaf))),
        )
    return out


def _world_program(mesh) -> dict:
    """One rank of the world of 4: reduced() params over (data=2, model=2),
    a batch over (pod=2, data=2)."""
    dm = tmesh.ProductionMesh(("data", "model"), (2, 2)).device_mesh("cpu")
    out = {}
    for arch, mode in WORLD_CASES:
        cfg = reduced(get_config(arch))
        params = init_params(cfg, 0, CPU)
        out[(arch, mode)] = _layout_checks(dm, sharding.param_pspecs(params, cfg, mode), params)
    pm = tmesh.ProductionMesh(("pod", "data"), (2, 2)).device_mesh("cpu")
    batch = {"tokens": torch.arange(8 * 3, dtype=torch.int32).reshape(8, 3),
             "mask": torch.rand(8, 3, generator=torch.Generator().manual_seed(1))}
    out["batch"] = _layout_checks(pm, sharding.batch_pspecs(batch, ("pod", "data")), batch)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tmesh.spawn_world(_world_program, [CPU] * 4, tmp_path_factory.mktemp("world4"))


@pytest.mark.parametrize("case", WORLD_CASES + ["batch"], ids=lambda c: "-".join(c) if isinstance(c, tuple) else c)
def test_fit_sharding_tree_lays_out_as_jax(world, case):
    """Each rank's local shard has the shape the fitted spec implies and
    is the block JAX's layout gives that rank (a tuple of axes split major
    first); ``full_tensor()`` gives back the leaf's bits."""
    sharded = 0
    for rank, res in enumerate(world):
        for key, r in res[case].items():
            assert r["local_shape_ok"] and r["block_ok"] and r["full_ok"], (rank, key, r)
            sharded += any(p is not None for p in r["spec"])
    assert sharded > 0
    if case == "batch":
        assert world[0]["batch"]["tokens"]["spec"] == (("pod", "data"), None)


# ---------------------------------------------------------------------------
# the legacy barrier round (src/repro/core/tmsn_sgd.py:179-264; tests/test_launch.py::TestTMSNSGD)
# ---------------------------------------------------------------------------

W, K, B, SEQ = 2, 2, 2, 32
#: AdamW's eps in the legacy-round comparison. At the default 1e-8 the
#: step g / (|g| + eps) of a gradient near 3e-8 turns the two packages'
#: float32 rounding difference there (4e-9, 1e-6 of the gradient's
#: scale) into a 2e-5 move of the weight, past atol 1e-5; at 1e-4 the
#: step is linear in such gradients and the comparison reads the round's
#: own logic. AdamW itself is held at its default in tests/test_torch_sgd.py.
ADAM_EPS = 1e-4


@pytest.fixture(scope="module")
def legacy_runs():
    """eps -> start -> the reference's and the port's two rounds, from the
    same converted params and the same batches (the reference's round
    jitted once per eps)."""
    jcfg, tcfg = jreduced(jget("yi-9b")), reduced(get_config("yi-9b"))
    jopt, topt = JAdamW(lr=1e-3, eps=ADAM_EPS), AdamWConfig(lr=1e-3, eps=ADAM_EPS)
    key = jax.random.PRNGKey(1)
    batches = []
    for r in range(2):
        b = jbatch(jax.random.fold_in(key, r), W * K * B, SEQ, jcfg.vocab)
        batches.append({k: np.asarray(v).reshape((W, K, B) + v.shape[1:]) for k, v in b.items()})
    p0 = np_tree(jinit(jcfg, jax.random.PRNGKey(0)))
    out = {}
    for eps in (0.0, 1e9, -1e9):
        jt = jtmsn.TMSNSGDConfig(num_workers=W, local_steps=K, eps=eps)
        tt = ttmsn.TMSNSGDConfig(num_workers=W, local_steps=K, eps=eps)
        fn = jax.jit(jtmsn.make_tmsn_round(jcfg, jopt, jt))
        rf = ttmsn.make_tmsn_round(tcfg, topt, tt)
        for start in ("sentinel", "finite"):
            jpw, jow, jcw = jtmsn.init_tmsn_state(jcfg, jopt, jt, jax.random.PRNGKey(0))
            tpw, tow, tcw = ttmsn.init_tmsn_state(tcfg, topt, tt, device=CPU,
                                                  params=convert.lm_params_from_numpy(p0, CPU))
            if start == "finite":  # loss-scale certificates: the argmin reads the losses
                jcw, tcw = jnp.asarray([6.74, 6.74], jnp.float32), torch.tensor([6.74, 6.74])
            rounds = []
            for bw in batches:
                jpw, jow, jcw, jl = fn(jpw, jow, jcw, bw)
                tpw, tow, tcw, tl = rf(tpw, tow, tcw, {k: torch.from_numpy(v.copy()) for k, v in bw.items()})
                rounds.append(dict(jcert=np.asarray(jcw), tcert=tcw.numpy().copy(), jloss=float(jl),
                                   tloss=float(tl), jstate=np_tree((jpw, jow)),
                                   tstate=tree_map(lambda a: a.clone(), (tpw, tow))))
            out[(eps, start)] = rounds
    return out


def _adopted(state_flat) -> bool:
    """Whether the two workers hold the same params and moments."""
    return all(np.array_equal(bits(np.asarray(v)[0]), bits(np.asarray(v)[1])) for v in state_flat.values())


@pytest.mark.parametrize("eps", [0.0, 1e9, -1e9])
@pytest.mark.parametrize("start", ["sentinel", "finite"])
@pytest.mark.parametrize("rnd", [0, 1])
def test_legacy_round_matches_reference(legacy_runs, eps, start, rnd):
    """make_tmsn_round against the reference's: certificates and the mean
    loss at rtol 1e-5, params, moments and steps leaf by leaf, and the
    same adoption (eps = 1e9 adopts nothing, -1e9 everything: the
    reference's test_adoption_copies_winner)."""
    r = legacy_runs[(eps, start)][rnd]
    np.testing.assert_allclose(r["tcert"], r["jcert"], **CERT)
    np.testing.assert_allclose(r["tloss"], r["jloss"], **CERT)
    got, want = tflat(r["tstate"]), jflat(r["jstate"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if g.dtype == torch.int32:  # the AdamW step counters
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), err_msg=k, **STATE)
    same = _adopted(want)
    assert _adopted({k: v.numpy() for k, v in got.items()}) == same
    if eps == 1e9:
        assert not same
    if eps == -1e9:
        assert same
    if start == "finite" and eps == 0.0 and rnd == 0:  # a real argmin: the loser adopts
        assert same and r["tcert"][0] == r["tcert"][1] and np.ptp(r["jcert"]) == 0


def test_init_tmsn_state_and_batch_specs():
    """init_tmsn_state: W copies of one model, the 1e9 sentinel;
    TestTMSNSGD.test_batch_specs, every leaf the reference's shape and dtype."""
    cfg = reduced(get_config("yi-9b"))
    tc = ttmsn.TMSNSGDConfig(num_workers=3, local_steps=2)
    pw, ow, cw = ttmsn.init_tmsn_state(cfg, AdamWConfig(), tc, 0, CPU)
    assert cw.tolist() == [1e9] * 3 and ow["step"].tolist() == [0, 0, 0]
    assert all(torch.equal(a[0], a[2]) for a in tree_leaves(pw))
    full = get_config("yi-9b")
    for cfg_name in ("yi-9b", "whisper-large-v3"):
        tcfg = ttmsn.TMSNSGDConfig(num_workers=16, local_steps=4)
        got = ttmsn.tmsn_batch_specs(get_config(cfg_name), tcfg, 4096, 256)
        want = jtmsn.tmsn_batch_specs(jget(cfg_name), jtmsn.TMSNSGDConfig(num_workers=16, local_steps=4), 4096, 256)
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape and str(got[k].dtype).split(".")[1] == str(want[k].dtype)
    assert ttmsn.tmsn_batch_specs(full, tcfg, 4096, 256)["tokens"].shape == (16, 4, 16, 4096)


# ---------------------------------------------------------------------------
# the training launch (src/repro/launch/train.py)
# ---------------------------------------------------------------------------


def _args(**kw):
    import argparse

    base = dict(steps=4, batch=2, seq=32, lr=1e-3, seed=0, ckpt=None, workers=2, local_steps=2, eps=0.0,
                device=CPU)
    return argparse.Namespace(**{**base, **kw})


def _ref_batches(cfg, n: int):
    key = jax.random.PRNGKey(7)
    return [jbatch(jax.random.fold_in(key, i), 2, 32, cfg.vocab) for i in range(n)]


def _port_batches(batches):
    return [{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in batches]


def test_train_sync_matches_reference_loop(tmp_path):
    """train_sync with the reference's batches and initial params against
    a loop of the reference's jitted make_train_step: the losses at rtol
    1e-5, and ``--ckpt`` writes the final params."""
    jcfg, tcfg = jreduced(jget("starcoder2-7b")), reduced(get_config("starcoder2-7b"))
    params = jinit(jcfg, jax.random.PRNGKey(0))
    batches = _ref_batches(jcfg, 4)
    step = jax.jit(jsteps.make_train_step(jcfg, JAdamW(lr=1e-3)))
    p, o, want = params, jinit_opt(params, JAdamW(lr=1e-3)), []
    for b in batches:
        p, o, m = step(p, o, b)
        want.append(float(m["loss"]))
    ckpt = str(tmp_path / "sync.npz")
    res = ttrain.train_sync(tcfg, _args(ckpt=ckpt), batches=_port_batches(batches),
                            params=convert.lm_params_from_numpy(np_tree(params), CPU))
    np.testing.assert_allclose(res["losses"], want, **CERT)
    assert len(res["step_seconds"]) == 4
    back = load_checkpoint(ckpt, tree_map(torch.zeros_like, res["params"]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(res["params"])))


def test_train_tmsn_matches_reference_rounds():
    """train_tmsn against the reference's train_tmsn loop (W * K batches a
    round, batch i to worker i // K as its step i % K): the rounds' mean
    losses and certificates at rtol 1e-5."""
    jcfg, tcfg = jreduced(jget("yi-9b")), reduced(get_config("yi-9b"))
    jt = jtmsn.TMSNSGDConfig(num_workers=2, local_steps=2, eps=0.0)
    opt = JAdamW(lr=1e-3)
    pw, ow, cw = jtmsn.init_tmsn_state(jcfg, opt, jt, jax.random.PRNGKey(0))
    fn = jax.jit(jtmsn.make_tmsn_round(jcfg, opt, jt))
    batches = _ref_batches(jcfg, 8)
    losses, certs = [], []
    for r in range(2):
        bs = batches[4 * r: 4 * r + 4]
        bw = {k: jnp.stack([b[k] for b in bs]).reshape((2, 2) + bs[0][k].shape) for k in bs[0]}
        pw, ow, cw, loss = fn(pw, ow, cw, bw)
        losses.append(float(loss))
        certs.append(np.asarray(cw))
    res = ttrain.train_tmsn(tcfg, _args(), batches=_port_batches(batches),
                            params=convert.lm_params_from_numpy(np_tree(jinit(jcfg, jax.random.PRNGKey(0))), CPU))
    np.testing.assert_allclose(res["losses"], losses, **CERT)
    np.testing.assert_allclose(res["history"], np.stack(certs), **CERT)
    assert res["history"].shape == (2, 2) and len(res["round_seconds"]) == 2


# ---------------------------------------------------------------------------
# analysis (src/repro/launch/analytic.py, hlo_analysis.py, dryrun.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_match_reference(arch):
    """step_counts for every input shape, dryrun_cfg'd and not, and
    active_param_fraction: the same floats (the same arithmetic)."""
    for jc, tc in ((jget(arch), get_config(arch)),
                   (jsteps.dryrun_cfg(jget(arch)), steps.dryrun_cfg(get_config(arch)))):
        for shape in jsteps.INPUT_SHAPES.values():
            assert analytic.step_counts(tc, shape, 123_456_789) == janalytic.step_counts(jc, shape, 123_456_789)
    assert dryrun.active_param_fraction(get_config(arch)) == japf(jget(arch))


def test_roofline_matches_reference():
    """``repro.launch.hlo_analysis.roofline`` on the same inputs."""
    for flops, nbytes in ((1e9, 1e6), (1.0, 1e12), (0.0, 0.0), (3e15, 7e11)):
        assert hlo_analysis.roofline(flops, nbytes, peak_flops=989e12, hbm_bw=3.35e12) == jhlo.roofline(
            flops, nbytes, peak_flops=989e12, hbm_bw=3.35e12)


def test_round_step_roofline_keys_and_floor():
    """The reference's keys and operand floor; the port counts its plain
    version's bytes op by op, which the fused kernel undercuts."""
    got = hlo_analysis.round_step_roofline(10, 64)
    want = jhlo.round_step_roofline(10, 64)
    assert set(want) <= set(got)
    assert got["operand_bytes"] == want["operand_bytes"] == (5 * 64 + 11) * 10 * 4
    assert got["bound"] == "memory" and got["fusion_overhead_x"] > 1.0 and got["ops_dispatched"] > 10


def _ref_nbytes(s) -> int:
    return int(np.prod(s.shape)) * np.dtype(s.dtype).itemsize


def _ref_divided(specs, shapes, sizes) -> int:
    """The reference-side sum: each leaf's bytes over the axes its
    reference fit_spec keeps."""
    sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    sh = jax.tree.leaves(shapes)
    assert len(sp) == len(sh)
    total = 0
    for spec, s in zip(sp, sh):
        fitted = jshard.fit_spec(spec, s.shape, sizes)
        total += _ref_nbytes(s) // sharding.shard_divisor(sharding.P(*fitted), sizes)
    return total


def _ref_argument_bytes(arch, shape, multi, tmsn) -> int:
    """build_case / build_tmsn_case's arguments and specs, from the
    reference's own functions (no mesh, no compile)."""
    cfg, sizes = jsteps.dryrun_cfg(jget(arch)), MESHES[multi]
    dp = ("pod", "data") if multi else ("data",)
    seq, gb, kind = jsteps.INPUT_SHAPES[shape]
    ps = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(0))
    if tmsn:
        w_axis = "pod" if multi else "data"
        tc = jtmsn.TMSNSGDConfig(num_workers=sizes[w_axis], local_steps=4)
        base = jshard.param_pspecs(ps, cfg)

        def lift(spec):
            parts = tuple(spec) if multi else tuple(None if p == "data" else p for p in spec)
            return JP(w_axis, *parts)

        pw = jax.tree.map(lift, base, is_leaf=lambda x: isinstance(x, JP))
        pws = jax.tree.map(lambda s: jax.ShapeDtypeStruct((tc.num_workers,) + s.shape, s.dtype), ps)
        odt = jnp.bfloat16 if jsteps.opt_config_for(cfg).state_dtype == "bfloat16" else jnp.float32
        mom = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, odt), pws)
        bs = jtmsn.tmsn_batch_specs(cfg, tc, seq, gb)
        bsp = jax.tree.map(lambda s: JP(w_axis, *((None,) * (len(s.shape) - 1))), bs)
        cert = jax.ShapeDtypeStruct((tc.num_workers,), jnp.float32)
        return (_ref_divided(pw, pws, sizes) + 2 * _ref_divided(pw, mom, sizes)
                + _ref_divided(JP(w_axis), jax.ShapeDtypeStruct((tc.num_workers,), jnp.int32), sizes)
                + _ref_divided(JP(w_axis), cert, sizes) + _ref_divided(bsp, bs, sizes))
    p_specs = jshard.param_pspecs(ps, cfg, mode="train" if kind == "train" else "serve")
    total = _ref_divided(p_specs, ps, sizes)
    if kind == "train":
        opt = jax.eval_shape(lambda: jinit_opt(ps, jsteps.opt_config_for(cfg)))
        total += _ref_divided(jshard.opt_pspecs(p_specs), opt, sizes)
    if kind in ("train", "prefill"):
        b = jsteps.batch_specs(cfg, shape)
        return total + _ref_divided(jshard.batch_pspecs(b, dp), b, sizes)
    d = jsteps.decode_specs(cfg, shape)
    long_ctx = gb == 1
    total += _ref_divided(jshard.cache_pspecs(d["caches"], cfg, dp, long_context=long_ctx), d["caches"], sizes)
    total += _ref_divided(JP(dp, None) if not long_ctx else JP(None, None), d["token"], sizes)
    return total + _ref_divided(JP(), d["pos"], sizes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_argument_bytes_match_reference(arch):
    """run_one on both production meshes, every shape and the TMSN round:
    no record is an error, skips are the reference's, and
    memory.argument_size_in_bytes equals the reference-side sum."""
    for multi in (False, True):
        for shape, (_, _, kind) in jsteps.INPUT_SHAPES.items():
            for tmsn in ((False, True) if kind == "train" else (False,)):
                rec = dryrun.run_one(arch, shape, multi, tmsn=tmsn)
                ok, _ = jsteps.shape_applicable(jsteps.dryrun_cfg(jget(arch)), shape)
                assert rec["status"] == ("ok" if ok else "skip"), rec.get("traceback")
                assert rec["mesh"] == ("2x16x16" if multi else "16x16") and rec["chips"] == (512 if multi else 256)
                if not ok:
                    continue
                assert rec["memory"]["argument_size_in_bytes"] == _ref_argument_bytes(arch, shape, multi, tmsn)
                assert rec["hlo_flops"] == rec["analytic"]["flops"] and rec["dominant"] in rec["terms"]
                assert set(rec["collective_bytes"]) == set(dryrun.COLLECTIVES)
                assert all(v >= 0 for v in rec["collective_bytes"].values())


def test_dryrun_cli_writes_records(tmp_path, monkeypatch, capsys):
    """``repro.launch.dryrun.main`` with --out: one record a case, named
    as the reference names them, with the reference's keys."""
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "mamba2_1p3b", "--out", str(tmp_path), "--multipod"])
    dryrun.main()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"mamba2_1p3b_{s}_2x16x16.json" for s in jsteps.INPUT_SHAPES)
    rec = json.loads((tmp_path / "mamba2_1p3b_decode_32k_2x16x16.json").read_text())
    for key in ("status", "analytic", "hlo_flops", "hlo_bytes", "model_flops", "useful_ratio", "params_b", "terms",
                "dominant", "memory", "collective_bytes"):
        assert key in rec
    assert "[ok   ]" in capsys.readouterr().out
    assert str(dryrun.RESULTS_DIR).endswith("build/dryrun")
