"""The port's architecture configs against the JAX package's, field for
field: every entry of ``ARCHS``, its parameter counts, its reduced
config, the shapes, which cells are defined, and the input specs (meta
tensors in the port, ShapeDtypeStructs in the JAX package)."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

import repro.configs as ref
import repro_torch.configs as port

ARCHS = sorted(ref.ARCHS)
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


def test_registry_has_the_same_architectures():
    assert sorted(port.ARCHS) == ARCHS
    assert port.SHAPES.keys() == ref.SHAPES.keys()
    for name in ref.SHAPES:
        assert dataclasses.asdict(port.SHAPES[name]) == \
            dataclasses.asdict(ref.SHAPES[name])


@pytest.mark.parametrize("name", ARCHS)
def test_config_fields_and_counts_equal(name):
    r, p = ref.get_arch(name), port.get_arch(name)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert p.param_count() == r.param_count()
    assert p.active_param_count() == r.active_param_count()
    for prop in ("head_dim", "d_inner", "n_ssm_heads", "dt_rank",
                 "has_attention", "subquadratic", "decoder"):
        assert getattr(p, prop) == getattr(r, prop), prop
    rr, pr = ref.reduced_config(r), port.reduced_config(p)
    assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
    assert pr.param_count() == rr.param_count()
    assert pr.active_param_count() == rr.active_param_count()


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("shape", sorted(ref.SHAPES))
def test_cells_and_input_specs_equal(name, shape):
    r, p = ref.get_arch(name), port.get_arch(name)
    rs, ps = ref.SHAPES[shape], port.SHAPES[shape]
    assert port.cell_supported(p, ps) == ref.cell_supported(r, rs)
    want = ref.input_specs(r, rs)
    got = port.input_specs(p, ps)
    assert got.keys() == want.keys()
    for key, spec in want.items():
        assert got[key].device.type == "meta"
        assert tuple(got[key].shape) == tuple(spec.shape), key
        assert got[key].dtype == DTYPES[jnp.dtype(spec.dtype)], key


def test_get_arch_rejects_unknown_names():
    with pytest.raises(KeyError, match="unknown arch"):
        port.get_arch("no-such-arch")
