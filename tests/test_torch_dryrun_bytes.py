"""The dry run's bytes (``repro_torch.launch.dryrun``) against the
reference's, exactly, for all 10 architectures at their published widths.

(a) ``param_bytes_global`` equals the reference's dry-run count,
    ``_tree_bytes(abstract_state(cfg, opt)[0])``.
(b) ``per_rank_bytes`` for each applicable shape (train_4k, prefill_32k,
    decode_32k, long_500k) on the meshes (data 16, model 16), (2, 2) and
    (1, 4): the parameters, Adam's state, the batch and the cache one rank
    holds equal the sum of ``NamedSharding(AbstractMesh(...), spec)
    .shard_shape`` bytes over the reference's ``param_shardings``,
    ``opt_shardings``, ``batch_shardings`` (``dp_axes`` of the global
    batch) and the sanitized ``cache_shardings`` of its
    ``abstract_cache`` (prefill and decode).

Both sides see abstract trees only (``jax.eval_shape``, ``meta``
tensors); no device is forced. The reference's ``eval_shape`` of
deepseek-v2-236b takes ~40 s of this file.
"""
import functools
import math

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_arch as jax_get_arch
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import input_specs as jax_input_specs
from repro.configs.shapes import shape_applicable as jax_shape_applicable
from repro.launch import mesh as jax_mesh
from repro.launch import shardings as jax_sh
from repro.train import lm_steps as jax_lm_steps
from repro.train.optimizer import Adam as JaxAdam
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.launch import dryrun

MESHES = {"data=16,model=16": (16, 16), "data=2,model=2": (2, 2),
          "data=1,model=4": (1, 4)}


@functools.lru_cache(maxsize=None)
def _reference_state(arch: str):
    return jax_lm_steps.abstract_state(jax_get_arch(arch), JaxAdam(lr=3e-4))


def _shard_bytes(tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
               for x, sh in zip(leaves, shs))


def _reference_per_rank(arch: str, shape: str, sizes) -> dict:
    """The reference's bytes one rank holds, from its shardings on an
    ``AbstractMesh``."""
    cfg = jax_get_arch(arch)
    sp = JAX_SHAPES[shape]
    mesh = AbstractMesh(sizes, ("data", "model"))
    params, opt = _reference_state(arch)
    dp = jax_mesh.dp_axes(mesh, sp.global_batch)
    p_sh = jax_sh.param_shardings(params, mesh)
    specs = jax_input_specs(cfg, shape)
    out = {"params": _shard_bytes(params, p_sh), "opt": 0, "cache": 0,
           "batch": _shard_bytes(specs, jax_sh.batch_shardings(specs, mesh,
                                                                dp))}
    if sp.kind == "train":
        out["opt"] = _shard_bytes(opt, jax_sh.opt_shardings(opt, p_sh, mesh))
    else:
        cache = jax_lm_steps.abstract_cache(cfg, sp.global_batch, sp.seq_len)
        out["cache"] = _shard_bytes(cache, jax_sh.sanitize_shardings(
            jax_sh.cache_shardings(cfg, mesh, dp), cache))
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_bytes_global_equals_reference(arch):
    """(a)"""
    params, _ = _reference_state(arch)
    want = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(params))
    assert dryrun.param_bytes_global(get_arch(arch)) == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_rank_bytes_equal_reference(arch, mesh):
    """(b) every applicable shape of ``arch`` on ``mesh``."""
    cfg = get_arch(arch)
    shapes = [s for s in SHAPES if shape_ok(cfg, arch, s)]
    assert "train_4k" in shapes
    for shape in shapes:
        sp = SHAPES[shape]
        ours = dryrun.per_rank_bytes(cfg, sp.kind, sp.global_batch,
                                     sp.seq_len, mesh)
        want = _reference_per_rank(arch, shape, MESHES[mesh])
        assert ours == {**want, "total": sum(want.values())}, (shape, mesh)


def shape_ok(cfg, arch: str, shape: str) -> bool:
    """The port's and the reference's ``shape_applicable`` agree; whether
    the cell runs."""
    ok = dryrun.shape_applicable(cfg, shape)[0]
    assert ok == jax_shape_applicable(jax_get_arch(arch), shape)[0]
    return ok
