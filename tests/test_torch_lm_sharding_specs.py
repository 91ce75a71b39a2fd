"""The port's host-side sharding code against the reference's, exactly.

Both sides see abstract state only: the reference's ``jax.eval_shape``
trees on ``jax.sharding.AbstractMesh``es (no devices), the port's
``meta`` tensors on unbound ``launch.mesh.Mesh``es. For all 10
architectures, full and smoke configs, on the meshes (data 2, model 2),
(4, 2), (16, 16), (pod 2, data 16, model 16) (FSDP over ``("pod",
"data")``), (data 4) and (data 1, model 2): every parameter's spec (by
the reference's tree path, and by the port's parameter name through
``convert.lm_param_shardings``), ``opt_shardings``,
``sanitize_shardings``, ``batch_shardings`` with ``dp_axes`` for global
batches 1-8 and ``cache_shardings``; and per architecture
``shape_applicable`` and ``input_specs`` for every shape,
``abstract_state``'s and ``abstract_cache``'s shapes and dtypes, and
``parse_mesh_spec``. Specs are compared as tuples of axis entries, which
is what both packages' spec types are.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import input_specs as jax_input_specs
from repro.configs.shapes import shape_applicable as jax_shape_applicable
from repro.launch import mesh as jax_mesh
from repro.launch import shardings as jax_sh
from repro.train import lm_steps as jax_lm_steps
from repro.train.optimizer import Adam as JaxAdam
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch, input_specs, \
    shape_applicable, smoke_config
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import Mesh, dp_axes, make_dp_mesh, \
    make_test_mesh, parse_mesh_spec
from repro_torch.train.lm_steps import abstract_cache, abstract_state
from repro_torch.train.optimizer import Adam

MESHES = [((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4,), ("data",)), ((1, 2), ("data", "model"))]
CASES = [(a, s) for a in sorted(JAX_ARCHS) for s in (False, True)]


def _meshes(sizes, names):
    return AbstractMesh(sizes, names), Mesh(sizes, names)


@functools.lru_cache(maxsize=None)
def _cfgs(arch: str, smoke: bool):
    if smoke:
        return smoke_config(arch), jax_smoke_config(arch)
    return get_arch(arch), jax_get_arch(arch)


@functools.lru_cache(maxsize=None)
def _jax_state(arch: str, smoke: bool):
    return jax_lm_steps.abstract_state(_cfgs(arch, smoke)[1], JaxAdam())


@functools.lru_cache(maxsize=None)
def _port_state(arch: str, smoke: bool):
    cfg = _cfgs(arch, smoke)[0]
    params, opt = abstract_state(cfg, Adam())
    named = dict(params.named_parameters())
    return (convert.lm_tree(named, cfg),
            {k: convert.lm_tree(opt[k], cfg) for k in ("m", "v")}, opt)


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def _jax_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {_path(p): tuple(s.spec) for p, s in leaves}


def _port_specs(tree) -> dict:
    return {p: tuple(s.spec) for p, s in sh.tree_leaves_with_path(tree)}


def _jax_shapes(tree) -> dict:
    return {_path(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_shapes(tree) -> dict:
    return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in sh.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch,smoke", CASES)
def test_param_and_opt_specs_equal_reference(arch, smoke):
    """Every parameter's spec on every mesh, by tree path and by the
    port's parameter name; Adam's m / v mirror them, the count is
    replicated."""
    jparams, jopt = _jax_state(arch, smoke)
    tree, moments, _ = _port_state(arch, smoke)
    cfg = _cfgs(arch, smoke)[0]
    for sizes, names in MESHES:
        jm, pm = _meshes(sizes, names)
        jps = jax_sh.param_shardings(jparams, jm)
        ps = sh.param_shardings(tree, pm)
        want = _jax_specs(jps)
        assert _port_specs(ps) == want, (arch, sizes)
        # by name: the reference's spec of the path, unstacked
        for name, s in convert.lm_param_shardings(cfg, pm).items():
            path, stacked = convert.lm_param_path(name, cfg)
            assert tuple(s.spec) == want[path][1 if stacked else 0:], name
        jos = _jax_specs(jax_sh.opt_shardings(jopt, jps, jm))
        pos = sh.opt_shardings(moments, ps, pm)
        assert _port_specs(pos) == jos
        assert tuple(pos["count"].spec) == jos["count"] == ()


@pytest.mark.parametrize("arch,smoke", CASES)
def test_sanitize_shardings_equal_reference(arch, smoke):
    """Every leaf given ``("data", "model", "pod")`` on its leading dims
    (as many as it has), then sanitized against its shape."""
    jparams, _ = _jax_state(arch, smoke)
    tree, _, _ = _port_state(arch, smoke)
    for sizes, names in MESHES:
        jm, pm = _meshes(sizes, names)
        want_axes = [a for a in ("data", "model", "pod") if a in names]

        def spec(ndim):
            return tuple(want_axes[:ndim])
        jin = jax.tree.map(lambda x: jax.sharding.NamedSharding(
            jm, jax.sharding.PartitionSpec(*spec(len(x.shape)))), jparams)
        pin = sh.tree_map_with_path(
            lambda p, x: sh.Sharding(pm, sh.P(*spec(len(x.shape)))), tree)
        assert _port_specs(sh.sanitize_shardings(pin, tree)) == \
            _jax_specs(jax_sh.sanitize_shardings(jin, jparams)), sizes


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_batch_and_cache_shardings_equal_reference(arch):
    """``batch_shardings`` of the train / prefill / decode inputs with
    ``dp_axes`` for global batches 1-8, and ``cache_shardings``."""
    cfg, jcfg = _cfgs(arch, False)
    for sizes, names in MESHES:
        jm, pm = _meshes(sizes, names)
        for b in range(1, 9):
            dp = dp_axes(pm, b)
            assert dp == jax_mesh.dp_axes(jm, b)
            for shape in JAX_SHAPES:
                ours = sh.batch_shardings(input_specs(cfg, shape, b), pm, dp)
                ref = jax_sh.batch_shardings(
                    jax_input_specs(jcfg, shape, b), jm, dp)
                assert {k: tuple(v.spec) for k, v in ours.items()} == \
                    {k: tuple(v.spec) for k, v in ref.items()}
            assert _port_specs(sh.cache_shardings(cfg, pm, dp)) == \
                _jax_specs(jax_sh.cache_shardings(jcfg, jm, dp))


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_shapes_and_abstract_state_equal_reference(arch):
    """``shape_applicable`` and ``input_specs`` (shapes and dtypes) for
    every shape; ``abstract_state`` (parameters and Adam's moments) of
    the full and smoke configs; ``abstract_cache``'s per-layer caches."""
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for smoke in (False, True):
        cfg, jcfg = _cfgs(arch, smoke)
        for shape in JAX_SHAPES:
            assert shape_applicable(cfg, shape) == \
                jax_shape_applicable(jcfg, shape)
            for b in (None, 3):
                ours = input_specs(cfg, shape, b)
                ref = jax_input_specs(jcfg, shape, b)
                assert all(t.device.type == "meta" for t in ours.values())
                assert {k: (tuple(v.shape), str(v.dtype).removeprefix(
                    "torch.")) for k, v in ours.items()} == \
                    {k: (tuple(v.shape), str(v.dtype)) for k, v in
                     ref.items()}
        jparams, jopt = _jax_state(arch, smoke)
        tree, moments, opt = _port_state(arch, smoke)
        assert _port_shapes(tree) == _jax_shapes(jparams)
        for k in ("m", "v"):
            assert _port_shapes(moments[k]) == _jax_shapes(jopt[k])
        assert opt["count"] == 0 and int(jopt["count"].shape == ()) == 1
        jcache = jax.eval_shape(functools.partial(
            jax_lm_steps.init_cache, jcfg, 2, 32))
        cache = abstract_cache(cfg, 2, 32)
        ref_layers = convert._unstack(
            jax.tree.map(lambda x: np.empty(x.shape, x.dtype), jcache), cfg)
        assert len(cache["layers"]) == len(ref_layers)
        for ours, ref in zip(cache["layers"], ref_layers):
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in ours.items()} == \
                {k: (tuple(np.shape(v)), str(np.asarray(v).dtype))
                 for k, v in ref.items()}
            assert all(v.device.type == "meta" for v in ours.values())


@pytest.mark.parametrize("spec", ["4", "data:4", "data:2,model:2",
                                  "pod:2,data:2,model:2"])
def test_parse_mesh_spec_equals_reference(spec, monkeypatch):
    """Axis names and sizes; the reference's meshes made abstract (its
    ``jax.make_mesh`` needs that many devices)."""
    monkeypatch.setattr(jax, "make_mesh", lambda shape, names, **_:
                        AbstractMesh(tuple(shape), tuple(names)))
    monkeypatch.setattr(jax, "devices", lambda *_: [None] * 8)
    ref = jax_mesh.parse_mesh_spec(spec)
    ours = parse_mesh_spec(spec)
    assert ours.axis_names == tuple(ref.axis_names)
    assert ours.shape == dict(ref.shape)
    assert ours.size == int(np.prod(list(ref.shape.values())))


def test_test_and_dp_meshes_equal_reference(monkeypatch):
    monkeypatch.setattr(jax, "make_mesh", lambda shape, names, **_:
                        AbstractMesh(tuple(shape), tuple(names)))
    monkeypatch.setattr(jax, "devices", lambda *_: [None] * 8)
    for ours, ref in ((make_test_mesh(8, model=2),
                       jax_mesh.make_test_mesh(8, model=2)),
                      (make_test_mesh(8, model=4),
                       jax_mesh.make_test_mesh(8, model=4)),
                      (make_dp_mesh(4), jax_mesh.make_dp_mesh(4))):
        assert ours.shape == dict(ref.shape)
        assert ours.axis_names == tuple(ref.axis_names)
    with pytest.raises(ValueError):
        make_test_mesh(6, model=4)


def test_sharding_blocks_and_replicas():
    """``Sharding.local_shape`` / ``local`` / ``lead`` on a (2, 2) mesh,
    with the rank of the mesh set by hand: the four blocks tile the
    array, and a block replicated over ``model`` leads on one rank of
    each pair."""
    mesh = Mesh((2, 2), ("data", "model"))
    s = sh.Sharding(mesh, sh.P("model", "data"))
    assert s.local_shape((8, 6)) == (4, 3)
    rep = sh.Sharding(mesh, sh.P(None, "data"))
    x = torch.arange(48).reshape(8, 6)
    blocks = {}
    for r in range(4):
        mesh.rank = r
        blocks[r] = (sh.Sharding(mesh, s.spec).local(x).clone(),
                     rep.lead)
    mesh.rank = None
    top = torch.cat([torch.cat([blocks[0][0], blocks[2][0]], 1),
                     torch.cat([blocks[1][0], blocks[3][0]], 1)], 0)
    assert torch.equal(top, x)
    assert [blocks[r][1] for r in range(4)] == [True, False, True, False]
