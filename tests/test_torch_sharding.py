"""The port's sharding (``repro_torch.models.sharding``, ``launch.mesh``,
``launch.dryrun``, the sharded train step, checkpoint and launcher)
against the JAX package's and against the port without a mesh.

Specs: every leaf's per-dimension mesh axes equal the reference's
``spec_for`` exactly, on the meshes (1, 1), (2, 2), (16, 16) and
(2, 16, 16), the reference run under ``use_sharding`` with a stand-in
mesh that has only ``axis_names`` and ``devices.shape`` (all its
``spec_for`` reads; its ``NamedSharding`` is replaced by the bare spec
with ``monkeypatch``).

Cross-rank numerics run on real process groups of 4 CPU ranks (gloo,
spawned, a ``FileStore`` under ``tmp_path``), in f64, at meshes 2 x 2 and
1 x 2 x 2, for one reduced config of each family the model has (dense,
moe, ssm, hybrid): the forward, the loss, the gradients, two train steps
and three decode steps (the cache split over ``cache_seq``) equal the
port without a mesh at ``F64_RTOL`` (1e-10 relative: the mesh only
reorders f64 sums), and the train steps equal the reference's f32 ones
within ``tests/test_torch_train.py``'s witness cap.  The dry run runs in
a subprocess on a fake group of 256 ranks (16 x 16) over meta tensors.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro.configs as rcfg
import repro.models.sharding as RSH
import repro.train.step as RST
import repro_torch.configs as pcfg
from repro.checkpoint import save as ref_save
from repro.models import params as RP
from repro.optim import adamw as RA
from repro.train import make_train_step as ref_train_step
from repro_torch.checkpoint import restore, save
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model as PM
from repro_torch.models import params as PP
from repro_torch.models import sharding as PSH
from repro_torch.optim import adamw as PA
from repro_torch.train import loss_and_grads, make_train_step
from repro_torch.train import step as PST
from test_torch_models import _cfgs, _strict
from test_torch_train import WITNESS_CAP, _rel, _torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(rcfg.ARCHS)
MESHES = [(1, 1), (2, 2), (16, 16), (2, 16, 16)]
FAMILIES = ["qwen2-0.5b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-2.7b"]
RANK_MESHES = [(2, 2), (1, 2, 2)]
F64_RTOL = 1e-10
B, S, DECODE_STEPS = 4, 16, 3
OPT = dict(warmup_steps=2, total_steps=6)
LAUNCH = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
          "--seq", "32", "--batch", "2", "--steps", "2"]
# the launcher trains the reduced qwen2 in bf16: a mesh sums the products
# of split contractions shard by shard, each rounded to bf16 (2^-8) first,
# and the loss averages that over the batch (measured: 6e-5 at 2 x 2)
LAUNCH_RTOL = 1e-3


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _jax_mesh(shape):
    return SimpleNamespace(axis_names=_axes(shape),
                           devices=SimpleNamespace(shape=tuple(shape)))


def _torch_mesh(shape):
    return SimpleNamespace(mesh_dim_names=_axes(shape), shape=tuple(shape))


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's sharding trees as bare ``PartitionSpec`` s."""
    monkeypatch.setattr(RSH, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(RST, "NamedSharding", lambda mesh, spec: spec)


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


# ---------------------------------------------------------------- specs
@pytest.mark.parametrize("shape", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", ARCHS)
def test_specs_equal_reference(name, shape, bare_specs):
    """Every leaf of the parameters, the optimizer state and the decode
    cache, and every input of every cell's batch: the port's spec equals
    the reference's, and its placements are that spec's."""
    rc, pc = rcfg.get_arch(name), pcfg.get_arch(name)
    jm, tm = _jax_mesh(shape), _torch_mesh(shape)
    with RSH.use_sharding(jm):
        want = {"params": _leaves(RP.param_shardings(rc)),
                "opt": _leaves(RST.opt_shardings(rc))}
        if rc.decoder:
            want["cache"] = _leaves(RST.cache_shardings(rc, 8, 64))
        for s, shp in rcfg.SHAPES.items():
            want[s] = _leaves(RST.batch_shardings(rc, shp, jm))
    with PSH.use_sharding(tm):
        specs = {"params": PP.tree_leaves(PP.param_specs(pc)),
                 "opt": [x for t in PA.opt_state_specs(pc)
                         for x in (PP.tree_leaves(t) if isinstance(t, dict)
                                   else [t])]}
        if pc.decoder:
            specs["cache"] = PP.tree_leaves(PM.cache_specs(pc, 8, 64))
        got = {k: [PSH.spec_for(s.axes, s.shape) for s in v]
               for k, v in specs.items()}
        placed = {"params": PP.tree_leaves(PP.param_shardings(pc)),
                  "opt": [x for t in PST.opt_shardings(pc)
                          for x in (PP.tree_leaves(t) if isinstance(t, dict)
                                    else [t])]}
        if pc.decoder:
            placed["cache"] = PP.tree_leaves(PST.cache_shardings(pc, 8, 64))
        for s, shp in pcfg.SHAPES.items():
            b = PST.batch_shardings(pc, shp)
            placed[s] = [b[k] for k in sorted(b)]
    for k in want:
        assert len(want[k]) == len(placed[k]), k
        assert k not in got or got[k] == [tuple(w) for w in want[k]], k
        assert placed[k] == [PSH.placements(tm, tuple(w)) for w in want[k]], k


def test_placements_split_over_two_axes():
    """A dimension split over ("pod", "data") is ``Shard(d)`` on both mesh
    dimensions, in mesh order; a mesh axis of size 1 splits nothing."""
    m = _torch_mesh((2, 16, 16))
    assert PSH.placements(m, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert PSH.placements(_torch_mesh((1, 2, 2)), (("pod", "data"),)) == (
        Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        PSH.placements(m, (("data", "pod"),))


# --------------------------------------------------------- use_sharding
def test_use_sharding_nests_and_restores():
    """As the reference: the innermost mesh and rules hold, the outer ones
    come back when a block ends, and no mesh means no split."""
    x = torch.ones(32, 4)
    assert PSH.spec_for(("batch", None), (32, 4)) == (None, None)
    assert PSH.shard(x, "batch", None) is x
    with PSH.use_sharding(_torch_mesh((16, 16))):
        assert PSH.spec_for(("batch", "ff"), (32, 16)) == ("data", "model")
        with PSH.use_sharding(_torch_mesh((2, 16, 16)), {"ff": None}):
            assert PSH.spec_for(("batch", "ff"), (32, 16)) == (
                ("pod", "data"), None)
        assert PSH.spec_for(("batch", "ff"), (32, 16)) == ("data", "model")
    assert PSH.active_mesh() is None


def test_use_sharding_is_per_thread():
    """Another thread sees no mesh while this one has one, and its own
    mesh does not leak back."""
    seen = {}

    def other():
        seen["before"] = PSH.active_mesh()
        with PSH.use_sharding(_torch_mesh((2, 2))):
            seen["inside"] = PSH.spec_for(("heads",), (4,))

    with PSH.use_sharding(_torch_mesh((16, 16))):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert PSH.spec_for(("heads",), (32,)) == ("model",)
    assert seen == {"before": None, "inside": ("model",)}


@pytest.mark.parametrize("rules", [
    {"ff": None}, {"batch": "data", "heads": None},
    {"p_in": ("pod", "data"), "vocab": None}, {"seq": "model"}])
def test_rule_overrides_equal_reference(rules):
    """A rule table that overrides the defaults gives the reference's
    specs, leaf for leaf, at qwen3-8b on the multi-pod mesh."""
    rc, pc = rcfg.get_arch("qwen3-8b"), pcfg.get_arch("qwen3-8b")
    logical = [(s.axes, s.shape) for s in PP.tree_leaves(PP.param_specs(pc))]
    logical += [(("batch", "seq", ax), (256, 4096, 4096))
                for ax in ("embed", "heads", "ff", "vocab")]
    with RSH.use_sharding(_jax_mesh((2, 16, 16)), rules):
        want = [tuple(RSH.spec_for(a, s)) for a, s in logical]
    with PSH.use_sharding(_torch_mesh((2, 16, 16)), rules):
        got = [PSH.spec_for(a, s) for a, s in logical]
    assert got == want


def test_shard_raises_on_a_plain_tensor_under_a_mesh():
    with PSH.use_sharding(_torch_mesh((2, 2))):
        with pytest.raises(TypeError, match="plain"):
            PSH.shard(torch.ones(4, 4), "batch", None)


def test_mesh_needs_its_process_group():
    """Without a group of the mesh's size the mesh is refused, and the
    message names the dry run."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="dryrun"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="4 ranks"):
        make_mesh((2, 2), ("data", "model"), "cpu")


# ---------------------------------------------------------------- dry run
DRYRUN = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import ARCHS, SHAPES, cell_supported, reduced_config
import repro_torch.launch.dryrun as D
D.get_arch = lambda a: reduced_config(ARCHS[a])
for a in sorted(ARCHS):
    for s in SHAPES:
        if cell_supported(ARCHS[a], SHAPES[s])[0]:
            print(json.dumps(D.run_cell(a, s, "pod")), flush=True)
"""


@pytest.fixture(scope="module")
def dryrun_records():
    """One run of every supported cell on the reduced configs, a fake
    16 x 16 group in a subprocess (the group must not outlive it)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c",
                          DRYRUN.format(src=str(ROOT / "src"))],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {(r["arch"], r["shape"]): r
            for r in map(json.loads, out.stdout.splitlines())}


def _cells():
    return [(a, s) for a in ARCHS for s in pcfg.SHAPES
            if pcfg.cell_supported(pcfg.ARCHS[a], pcfg.SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", _cells())
def test_dryrun_cell_runs(arch, shape, dryrun_records, bare_specs):
    """The cell completes on 256 fake ranks, and each rank's parameter
    bytes are the sum of the local shards the reference's specs imply."""
    rec = dryrun_records[arch, shape]
    assert rec["chips"] == 256 and rec["mesh"] == "pod"
    rc = rcfg.reduced_config(rcfg.get_arch(arch))
    sizes = {"data": 16, "model": 16}
    want = 0
    with RSH.use_sharding(_jax_mesh((16, 16))):
        for spec, leaf in zip(_leaves(RP.param_shardings(rc)),
                              jax.tree.leaves(RP.abstract_params(rc))):
            n = leaf.dtype.itemsize
            for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * 8):
                axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                n *= dim // int(np.prod([sizes[a] for a in axes]))
            want += n
    mem = rec["memory"]
    assert mem["params_bytes"] == want
    assert mem["total_bytes"] == sum(mem[k] for k in (
        "params_bytes", "opt_state_bytes", "cache_bytes", "batch_bytes"))
    assert mem["peak_bytes"] == mem["total_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["lower_s"] > 0
    if pcfg.SHAPES[shape].kind == "train":
        assert mem["opt_state_bytes"] == 2 * want + 4


def test_dryrun_train_cell_never_gathers_the_logits(dryrun_records):
    """No all-gather in a train cell is as large as one rank's (B, S, V)
    f32 logits gathered over the vocabulary: the loss reduces the split
    vocabulary by a max and a sum."""
    for (arch, shape), rec in dryrun_records.items():
        if shape != "train_4k":
            continue
        cfg = pcfg.reduced_config(pcfg.get_arch(arch))
        sh = pcfg.SHAPES[shape]
        gathered = sh.global_batch // 16 * sh.seq_len * cfg.vocab * 4
        gather = rec["collectives"].get("all_gather_into_tensor",
                                        {"max_result_bytes": 0})
        assert gather["max_result_bytes"] < gathered, (arch, gather)


# --------------------------------------------------- 4 ranks on the CPU
def _f64(name):
    return dataclasses.replace(pcfg.reduced_config(pcfg.get_arch(name)),
                               dtype="float64")


def _masters(name):
    """The reference's f32 init of ``name`` (reduced) and the same numbers
    as f64 port masters."""
    rc, _ = _cfgs(name, "float32")
    ref = RP.init_params(rc, jax.random.PRNGKey(0))
    return ref, PP.tree_map(lambda a: torch.from_numpy(
        np.asarray(a, np.float64)), jax.tree.map(np.asarray, ref))


def _family_run(name, params, mesh=None):
    """The forward, loss and gradients on step 0's batch, two train steps,
    and three decode steps (positions 0-2) from a zero cache, for the f64
    config of ``name`` on ``params``; under ``mesh`` every input laid out
    on it.  Everything returned whole (gathered)."""
    cfg = _f64(name)
    shape = ShapeConfig("t", S, B, "train")
    pipe = SyntheticTokenPipeline(cfg, shape)
    full = PSH.full
    with PSH.use_sharding(mesh):
        place = PST.batch_shardings(cfg, shape) if mesh else None
        p = PP.distribute_params(cfg, params)
        batch = pipe.device_batch(0, "cpu", place)
        out = {"logits": full(PM.forward(cfg, p, batch))}
        loss, grads = loss_and_grads(cfg, p, batch)
        out["loss"], out["grads"] = full(loss), PP.tree_map(full, grads)
        step = make_train_step(cfg, PA.AdamWConfig(**OPT))
        q, opt, losses = p, PA.init_opt_state(p), []
        for s in range(2):
            q, opt, info = step(q, opt, pipe.device_batch(s, "cpu", place))
            losses.append(info["loss"])
        out["losses"], out["params"] = losses, PP.tree_map(full, q)
        out["mu"] = PP.tree_map(full, opt.mu)
        dshape = ShapeConfig("d", S, B, "decode")
        dplace = PST.batch_shardings(cfg, dshape) if mesh else None
        cache = PP.tree_map(PSH.distribute, PM.init_cache(cfg, B, S, "cpu"),
                            PST.cache_shardings(cfg, B, S))
        toks = torch.from_numpy(pipe.batch_for_step(7)["tokens"][:, :1])
        out["decode"] = []
        for t in range(DECODE_STEPS):
            pos = torch.full((B,), t, dtype=torch.int32)
            tk = PSH.distribute((toks + t) % cfg.vocab,
                                dplace and dplace["tokens"])
            logits, cache = PM.decode_step(
                cfg, p, cache, tk,
                PSH.distribute(pos, dplace and dplace["positions"]))
            out["decode"].append(full(logits))
        out["cache"] = PP.tree_map(full, cache)
    return out


def _rank_main(rank, store, work):
    """One of 4 ranks: every family on each mesh of ``RANK_MESHES``; at
    2 x 2 also the checkpoint (saved at 2 x 2, restored at 4 x 1; the
    reference's restored at 2 x 2) and the launcher at ``--mesh 2x2``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    try:
        work = Path(work)
        for shape in RANK_MESHES:
            mesh = make_mesh(shape, _axes(shape), "cpu")
            res = {name: _family_run(name, torch.load(work / f"{name}.pt"),
                                     mesh) for name in FAMILIES}
            if shape == (2, 2):
                res["checkpoint"] = _rank_checkpoint(work, mesh)
                res["launcher"] = LT.main(LAUNCH + ["--mesh", "2x2"])
            if rank == 0:
                torch.save(res, work / f"mesh_{'x'.join(map(str, shape))}.pt")
    finally:
        dist.destroy_process_group()


def _state(cfg, params, opt):
    return {"p": PP.distribute_params(cfg, params),
            "o": PA.OptState(*(PP.tree_map(PSH.distribute, t, s) if
                               isinstance(t, dict) else PSH.distribute(t, s)
                               for t, s in zip(opt, PST.opt_shardings(cfg))))}


def _placed(cfg):
    return {"p": PP.param_shardings(cfg), "o": PST.opt_shardings(cfg)}


def _whole(tree):
    from repro_torch.checkpoint.checkpoint import _paths
    return {"/".join(k): PSH.full(v) for k, v in _paths(tree)}


def _rank_checkpoint(work, mesh):
    """Saves qwen2's state at 2 x 2 and restores it at 4 x 1; restores
    the reference's checkpoint at 2 x 2.  Returns both whole."""
    cfg = _f64("qwen2-0.5b")
    saved = torch.load(work / "state.pt", weights_only=False)
    with PSH.use_sharding(mesh):
        save(work / "ck", 5, _state(cfg, saved["p"], saved["o"]))
        ref = restore(work / "ref_ck", 1, {"p": saved["p"], "o": saved["o"]},
                      "cpu", _placed(cfg))
        ref = _whole(ref)
    with PSH.use_sharding(make_mesh((4, 1), ("data", "model"), "cpu")):
        back = _whole(restore(work / "ck", 5, saved, "cpu", _placed(cfg)))
    return {"restored_4x1": back, "reference_2x2": ref}


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """The f64 masters of each family (the reference's f32 init), a saved
    state and the reference's checkpoint in a work directory, then one
    spawn of 4 ranks (:func:`_rank_main`)."""
    work = tmp_path_factory.mktemp("ranks")
    masters = {}
    for name in FAMILIES:
        ref, params = _masters(name)
        masters[name] = (ref, params)
        torch.save(params, work / f"{name}.pt")
    params = masters["qwen2-0.5b"][1]
    opt = PA.init_opt_state(params)
    opt = PA.OptState(PP.tree_map(lambda a: a + 0.5, opt.mu),
                      PP.tree_map(lambda a: a + 0.25, opt.nu),
                      torch.tensor(3, dtype=torch.int32))
    torch.save({"p": params, "o": opt}, work / "state.pt")
    rref = masters["qwen2-0.5b"][0]
    ref_save(str(work / "ref_ck"), 1, {"p": rref,
                                       "o": RA.init_opt_state(rref)})
    mp.start_processes(_rank_main, args=(str(work / "store"), str(work)),
                       nprocs=4, join=True, start_method="spawn")
    return work, masters, _f64("qwen2-0.5b")


def _held(got, want, what):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(w).max()), 1e-300)
    assert float(np.abs(g - w).max()) <= F64_RTOL * scale, (what, float(
        np.abs(g - w).max()), scale)


@pytest.mark.parametrize("shape", RANK_MESHES,
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", FAMILIES)
def test_four_ranks_equal_the_unsharded_port(name, shape, rank_runs):
    """The forward, loss, every gradient leaf, two train steps (losses,
    parameters, mu) and three decode steps (logits, the whole cache) on 4
    ranks equal the port without a mesh at ``F64_RTOL``."""
    work, masters, _ = rank_runs
    got = torch.load(work / f"mesh_{'x'.join(map(str, shape))}.pt")[name]
    want = _family_run(name, masters[name][1])
    for key in ("logits", "loss"):
        _held(got[key], want[key], key)
    _held(got["losses"], want["losses"], "losses")
    for key in ("grads", "params", "mu", "cache"):
        for g, w in zip(PP.tree_leaves(got[key]), PP.tree_leaves(want[key])):
            _held(g, w, key)
    for g, w in zip(got["decode"], want["decode"]):
        _held(g, w, "decode")


@pytest.mark.parametrize("name", FAMILIES)
def test_four_ranks_equal_the_reference_train_step(name, rank_runs):
    """The 2 x 2 run's two train steps against the reference's f32 steps
    from the same weights on the same batches: losses at 1e-5, each
    parameter leaf within ``WITNESS_CAP`` (the reference's own f32 error
    against the port's exact f64 result, as ``test_torch_train.py``
    holds it)."""
    work, masters, _ = rank_runs
    got = torch.load(work / "mesh_2x2.pt")[name]
    rc, _ = _cfgs(name, "float32")
    ref = masters[name][0]
    rstep = ref_train_step(rc, RA.AdamWConfig(**OPT))
    state, fn, losses = RA.init_opt_state(ref), None, []
    pipe = SyntheticTokenPipeline(_f64(name), ShapeConfig("t", S, B, "train"))
    for s in range(2):
        jb = {k: jnp.asarray(v) for k, v in pipe.batch_for_step(s).items()}
        fn = fn or _strict(rstep, ref, state, jb)
        ref, state, info = fn(ref, state, jb)
        losses.append(float(info["loss"]))
    np.testing.assert_allclose([float(x) for x in got["losses"]], losses,
                               rtol=1e-5)
    for g, w in zip(PP.tree_leaves(got["params"]), jax.tree.leaves(ref)):
        assert _rel(w, g) <= WITNESS_CAP["train_step"], _rel(w, g)


def test_checkpoint_reshards_bit_for_bit(rank_runs):
    """Saved at 2 x 2: restored at 4 x 1, at 1 x 1 (a one-rank group) and
    with no mesh, every leaf equals the state that was saved bit for bit;
    the reference's checkpoint restored at 2 x 2 equals its arrays."""
    work, masters, cfg = rank_runs
    saved = torch.load(work / "state.pt", weights_only=False)
    want = _whole(saved)
    got = torch.load(work / "mesh_2x2.pt")["checkpoint"]
    plain = _whole(restore(work / "ck", 5, saved, "cpu"))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with PSH.use_sharding(make_mesh((1, 1), ("data", "model"), "cpu")):
            one = restore(work / "ck", 5, saved, "cpu", _placed(cfg))
            assert isinstance(one["p"]["embed"], DTensor)
            one = _whole(one)
    finally:
        dist.destroy_process_group()
    for tree in (got["restored_4x1"], plain, one):
        assert sorted(tree) == sorted(want)
        for k in want:
            assert torch.equal(tree[k], want[k]), k
    rref = masters["qwen2-0.5b"][0]
    rwant = {"p/" + "/".join(str(getattr(p, "key", p)) for p in path):
             np.asarray(leaf) for path, leaf in
             jax.tree_util.tree_flatten_with_path(rref)[0]}
    for k, w in rwant.items():
        np.testing.assert_array_equal(got["reference_2x2"][k].numpy(), w)


def test_launcher_on_four_ranks_gives_the_one_rank_losses(rank_runs):
    """``main(["--mesh", "2x2", ...])`` on 4 ranks against ``--mesh 1x1``
    run alone (its own one-rank group): the same losses at
    ``LAUNCH_RTOL``."""
    work, _, _ = rank_runs
    got = torch.load(work / "mesh_2x2.pt")["launcher"]
    want = LT.main(LAUNCH + ["--mesh", "1x1"])
    assert not dist.is_initialized()
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=LAUNCH_RTOL)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "zamba2-2.7b"])
def test_backward_runs_off_the_forward_thread(name):
    """Autograd runs a CUDA backward on a thread of its own, where the
    forward's thread-local mesh is not in force: under a one-rank mesh,
    the loss's gradient taken on another thread (remat recomputes each
    layer there, the embedding's custom gradient runs there) equals the
    one taken on the forward's thread, bit for bit."""
    cfg = _f64(name)
    params = _masters(name)[1]
    batch = SyntheticTokenPipeline(cfg, ShapeConfig("t", S, B, "train"))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        grads = []
        for thread in (False, True):
            with PSH.use_sharding(mesh):
                p = PP.distribute_params(cfg, params)
                flat = [a.detach().requires_grad_() for a in
                        PP.tree_leaves(p)]
                it = iter(flat)
                loss = PM.loss_fn(cfg, PP.tree_map(lambda _: next(it), p),
                                  batch.device_batch(0, "cpu", PST.
                                                     batch_shardings(
                                                         cfg, batch.shape)))
            out = []

            def back():
                out.append(torch.autograd.grad(loss, flat))

            if thread:
                t = threading.Thread(target=back)
                t.start()
                t.join(timeout=300)
                assert not t.is_alive()
            else:
                back()
            grads.append([g.full_tensor() for g in out[0]])
    finally:
        dist.destroy_process_group()
    for a, b in zip(*grads):
        assert torch.equal(a, b)
