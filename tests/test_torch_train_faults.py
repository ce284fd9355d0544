"""A fault of the reference's training path, shown in the port: at full
width the ssm (falcon-mamba-7b) and hybrid (zamba2-2.7b) families give
non-finite gradients, though the loss is finite.  At the reduced configs
every gradient is finite (``tests/test_smoke_archs.py``).

Each case runs 2 layers at full width (zamba2: one group of 2 Mamba-2
layers and its shared block), f32, B 1, S 512, on the reference's
``init_params(PRNGKey(0))`` carried across by ``params_from_jax``: the
port's loss equals the reference's at 1e-5 relative, and the same set
of gradient leaves is non-finite on both sides (measured: falcon-mamba
11 leaves, every Mamba-1 leaf and ``embed``; zamba2 10, every Mamba-2
leaf and ``embed``).  The port keeps the reference's algebra, so it
keeps the fault; ``ROADMAP.md`` §3 records the operations that cause it
(ssm: the chunked scan's ``deltaBx / max(cumA, 1e-20)`` once ``cumA``
underflows; hybrid: ``where(tri, exp(diff), 0)`` whose masked
``exp(diff)`` overflows) and the fix left to decide.  Each case takes
about 10 GB and 45 s on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro_torch.configs as pcfg
from repro.configs.base import ShapeConfig
from repro.data import SyntheticTokenPipeline
from repro.models import model as RM
from repro.models import params as RP
from repro_torch.models import params_from_jax
from repro_torch.models import params as PP
from repro_torch.train import loss_and_grads

FAULTY = {"falcon-mamba-7b": {"n_layers": 2},
          "zamba2-2.7b": {"n_layers": 2, "attn_every": 2}}


def _paths(tree):
    """Path strings of a gradient tree's leaves, in flattening order."""
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("name", sorted(FAULTY))
def test_full_width_nonfinite_gradients_as_the_reference(name):
    kw = dict(FAULTY[name], dtype="float32")
    rc = dataclasses.replace(rcfg.get_arch(name), **kw)
    pc = dataclasses.replace(pcfg.get_arch(name), **kw)
    ref = RP.init_params(rc, jax.random.PRNGKey(0))
    batch = SyntheticTokenPipeline(rc, ShapeConfig("t", 512, 1, "train")) \
        .batch_for_step(0)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(rc, p, b)))(
        ref, {k: jnp.asarray(v) for k, v in batch.items()})
    keys = _paths(want)
    want_bad = {k for k, g in zip(keys, jax.tree.leaves(want))
                if not np.isfinite(np.asarray(g)).all()}
    del want
    params = params_from_jax(jax.tree.map(np.asarray, ref), "cpu")
    del ref
    loss, grads = loss_and_grads(
        pc, params, {k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in batch.items()})
    got_bad = {k for k, g in zip(keys, PP.tree_leaves(grads))
               if not bool(torch.isfinite(g).all())}
    assert np.isfinite(float(want_loss)) and np.isfinite(float(loss))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    assert "['embed']" in want_bad and len(want_bad) >= 10, want_bad
    assert got_bad == want_bad
