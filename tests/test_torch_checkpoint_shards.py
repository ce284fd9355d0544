"""The port's sharded checkpoint (``repro_torch.checkpoint``) saves and
restores shard by shard on the host.

One spawn of 4 gloo ranks (a ``FileStore`` under ``tmp_path``) at the
reduced qwen2-0.5b: the parameters, the optimizer state and a bf16 leaf
laid out on a (2, 2) mesh are saved, then restored at (2, 2) and at
(4, 1); a one-rank group restores at (1, 1).  Under ``CommDebugMode``
neither the save nor the restore issues an all-gather, a scatter or any
other collective but the save's barriers: no rank ever holds a whole
sharded leaf on its device.  Every file, the manifest included, is byte
for byte the one a mesh-less save of the same state writes, and every
restore equals the saved state bit for bit.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

import repro_torch.configs as pcfg
from repro_torch.checkpoint import restore, save
from repro_torch.checkpoint.checkpoint import _at, _paths, _rebuild
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import params as PP
from repro_torch.models import sharding as PSH
from repro_torch.optim import adamw as PA
from repro_torch.train import step as PST

AXES = ("data", "model")


def _cfg():
    return dataclasses.replace(pcfg.reduced_config(
        pcfg.get_arch("qwen2-0.5b")), dtype="float32")


def _state():
    """A state with f32 parameters, f32 moments, an int32 step and a bf16
    leaf, every value distinct."""
    cfg = _cfg()
    params = PP.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    opt = PA.init_opt_state(params)
    opt = PA.OptState(PP.tree_map(lambda a: a + 0.5, opt.mu),
                      PP.tree_map(lambda a: a * a + 0.25, params),
                      torch.tensor(7, dtype=torch.int32))
    return {"p": params, "o": opt,
            "b": {"w": params["embed"].to(torch.bfloat16)}}


def _placed(cfg):
    p = PP.param_shardings(cfg)
    return {"p": p, "o": PST.opt_shardings(cfg), "b": {"w": p["embed"]}}


def _laid_out(tree, placed):
    return _rebuild(tree, iter(PSH.distribute(x, _at(placed, k))
                               for k, x in _paths(tree)))


def _whole(tree):
    return {"/".join(k): PSH.full(v) for k, v in _paths(tree)}


def _ops(mode):
    return {str(op).split(".")[-1]: n
            for op, n in mode.get_comm_counts().items() if n}


def _rank_main(rank, store, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    try:
        work = Path(work)
        cfg, state = _cfg(), torch.load(work / "state.pt",
                                        weights_only=False)
        res = {}
        with PSH.use_sharding(make_mesh((2, 2), AXES, "cpu")):
            laid = _laid_out(state, _placed(cfg))
            with CommDebugMode() as comm:
                save(work / "mesh", 1, laid)
            res["save_ops"] = _ops(comm)
            with CommDebugMode() as comm:
                back = restore(work / "mesh", 1, state, "cpu", _placed(cfg))
            res["restore_ops"] = _ops(comm)
            res["dtensor"] = all(isinstance(x, DTensor)
                                 for _, x in _paths(back))
            res["2x2"] = _whole(back)
        with PSH.use_sharding(make_mesh((4, 1), AXES, "cpu")):
            res["4x1"] = _whole(restore(work / "mesh", 1, state, "cpu",
                                        _placed(cfg)))
        if rank == 0:
            torch.save(res, work / "ranks.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    """The state, its mesh-less save, then one spawn of 4 ranks."""
    work = tmp_path_factory.mktemp("shards")
    state = _state()
    torch.save(state, work / "state.pt")
    save(work / "plain", 1, state)
    mp.start_processes(_rank_main, args=(str(work / "store"), str(work)),
                       nprocs=4, join=True, start_method="spawn")
    return work, state, torch.load(work / "ranks.pt")


def test_save_and_restore_issue_no_gather_or_scatter(shard_runs):
    _, _, res = shard_runs
    assert set(res["save_ops"]) <= {"barrier"}, res["save_ops"]
    assert res["restore_ops"] == {}, res["restore_ops"]
    assert res["dtensor"]


def test_files_equal_a_mesh_less_save_byte_for_byte(shard_runs):
    work, state, _ = shard_runs
    mesh, plain = work / "mesh" / "step_1", work / "plain" / "step_1"
    names = sorted(p.name for p in plain.iterdir())
    assert names == sorted(p.name for p in mesh.iterdir())
    assert len(names) == len(list(_paths(state))) + 1   # + manifest
    for name in names:
        assert (mesh / name).read_bytes() == (plain / name).read_bytes(), \
            name


@pytest.mark.parametrize("where", ["2x2", "4x1", "1x1", "none"])
def test_restores_equal_the_saved_state_bit_for_bit(shard_runs, where):
    work, state, res = shard_runs
    want = _whole(state)
    if where in res:
        got = res[where]
    elif where == "none":
        got = _whole(restore(work / "mesh", 1, state, "cpu"))
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            with PSH.use_sharding(make_mesh((1, 1), AXES, "cpu")):
                one = restore(work / "mesh", 1, state, "cpu",
                              _placed(_cfg()))
                assert isinstance(one["b"]["w"], DTensor)
                got = _whole(one)
        finally:
            dist.destroy_process_group()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert want["b/w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["o/.step"].numpy(), 7)
