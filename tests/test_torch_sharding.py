"""The port's sharding rules (``repro_torch.launch.sharding``,
``models.shard_ctx``) against ``repro.launch.sharding`` / ``shard_ctx``.

Every leaf of every config at full size: the port's parameters, caches
and optimizer states as meta tensors (shapes only), the reference's
through ``jax.eval_shape``.  The rules read only a mesh's axis names and
sizes, so the reference runs on stand-in meshes of the production shapes
(its ``NamedSharding`` constructor, which needs real devices, is swapped
for a record of the spec); the port on its own meshes of meta shards.
Specs compare as tuples.  Argument bytes a device: the port's
``shard_bytes`` against the bytes the reference's specs give.
"""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import sharding as ref_shd
from repro.models import shard_ctx as ref_ctx
from repro.models.api import build_model as ref_build
from repro.models.common import dtype_of as ref_dtype_of
from repro.optim import adamw_init as ref_adamw_init
from repro.optim.adamw8bit import adamw8bit_init as ref_adamw8bit_init

from repro_torch import configs
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.specs import arg_bytes, build_cell
from repro_torch.models import shard_ctx
from repro_torch.models.api import build_model
from repro_torch.models.common import dtype_of
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw8bit import adamw8bit_init

ARCHS = ref_configs.ARCHS


class _FakeMesh:
    """The reference's test stand-in: axis names and sizes only."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {
    "single": ({"data": 16, "model": 16},
               lambda: make_production_mesh(devices="meta")),
    "multi": ({"pod": 2, "data": 16, "model": 16},
              lambda: make_production_mesh(multi_pod=True, devices="meta")),
    "test24": ({"data": 2, "model": 4},
               lambda: make_test_mesh(devices=["meta"] * 8)),
}


class _NS:
    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


@pytest.fixture
def ref_records_specs(monkeypatch):
    """The reference's ``NamedSharding`` as a plain (mesh, spec) record."""
    monkeypatch.setattr(ref_shd, "NamedSharding", _NS)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def _ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, _NS))[0]
    return {"/".join(str(e.key) for e in path): leaf for path, leaf in leaves}


def _spec(x) -> tuple:
    return tuple(x.spec if hasattr(x, "spec") else x)


_REF_PARAMS: dict = {}
_PORT_PARAMS: dict = {}


def ref_params(arch):
    if arch not in _REF_PARAMS:
        model = ref_build(ref_configs.get_config(arch))
        _REF_PARAMS[arch] = (model, jax.eval_shape(model.init,
                                                   jax.random.PRNGKey(0)))
    return _REF_PARAMS[arch]


def port_params(arch):
    if arch not in _PORT_PARAMS:
        model = build_model(configs.get_config(arch), device="meta")
        _PORT_PARAMS[arch] = (model, model.init(0))
    return _PORT_PARAMS[arch]


def _ref_param_specs(arch, mesh, serving):
    _, shapes = ref_params(arch)
    return {k: tuple(v) for k, v in _ref_flat(jax.tree_util.tree_map_with_path(
        lambda path, leaf: ref_shd.param_spec(path, leaf, mesh,
                                              serving=serving),
        shapes)).items()}


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_every_leaf(arch, mesh_kind):
    shape, make = MESHES[mesh_kind]
    ref_mesh, mesh = _FakeMesh(shape), make()
    _, params = port_params(arch)
    for serving in (False, True):
        want = _ref_param_specs(arch, ref_mesh, serving)
        got = {k: _spec(v) for k, v in _flat(
            shd.param_shardings(params, mesh, serving=serving)).items()}
        assert got == want, (arch, mesh_kind, serving)


def _shard_bytes_from_spec(shape, dtype_bytes, spec, mesh_shape) -> int:
    n = math.prod(shape)
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n //= mesh_shape[a]
    return n * dtype_bytes


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_a_device(arch, mesh_kind):
    shape, make = MESHES[mesh_kind]
    mesh = make()
    _, params = port_params(arch)
    _, ref = ref_params(arch)
    for serving in (False, True):
        specs = _ref_param_specs(arch, _FakeMesh(shape), serving)
        want = sum(_shard_bytes_from_spec(leaf.shape, leaf.dtype.itemsize,
                                          specs[k], shape)
                   for k, leaf in _ref_flat(ref).items())
        got = shd.shard_bytes(params, shd.param_shardings(
            params, mesh, serving=serving))
        assert got == want, (arch, mesh_kind, serving)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "granite_moe_3b_a800m",
                                  "zamba2_1_2b", "xlstm_125m"])
def test_optimizer_state_rules(arch, mesh_kind, ref_records_specs):
    shape, make = MESHES[mesh_kind]
    ref_mesh, mesh = _FakeMesh(shape), make()
    _, ref_p = ref_params(arch)
    _, params = port_params(arch)
    want = _ref_flat(ref_shd.opt_state_shardings(
        jax.eval_shape(ref_adamw_init, ref_p), ref_p, ref_mesh))
    got = _flat(shd.opt_state_shardings(params, mesh))
    assert {k: _spec(v) for k, v in got.items()} == \
        {k: _spec(v) for k, v in want.items()}
    want8 = _ref_flat(ref_shd.opt8_state_shardings(
        jax.eval_shape(ref_adamw8bit_init, ref_p), ref_p, ref_mesh))
    got8 = _flat(shd.opt8_state_shardings(params, mesh))
    assert {k: _spec(v) for k, v in got8.items()} == \
        {k: _spec(v) for k, v in want8.items()}
    # the port's states have the leaves the rules name
    assert set(_flat(adamw8bit_init(params))) == set(got8)
    assert set(_flat(adamw_init(params))) == set(got)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_rules_every_leaf(arch, shape_name, mesh_kind,
                                ref_records_specs):
    shape, make = MESHES[mesh_kind]
    ref_mesh, mesh = _FakeMesh(shape), make()
    sh = configs.SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    ref_model, _ = ref_params(arch)
    cfg = ref_configs.get_config(arch)
    ref_cache = jax.eval_shape(lambda: ref_model.init_cache(
        B, S, ref_dtype_of(cfg.kv_cache_dtype)))
    model, _ = port_params(arch)
    cache = model.init_cache(B, S, dtype_of(cfg.kv_cache_dtype))
    want = _ref_flat(ref_shd.cache_shardings(ref_cache, ref_mesh))
    got = _flat(shd.cache_shardings(cache, mesh))
    assert {k: _spec(v) for k, v in got.items()} == \
        {k: _spec(v) for k, v in want.items()}
    for k, leaf in _flat(cache).items():
        assert tuple(leaf.shape) == tuple(_ref_flat(ref_cache)[k].shape)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_batch_spec(mesh_kind):
    shape, make = MESHES[mesh_kind]
    ref_mesh, mesh = _FakeMesh(shape), make()
    for shp in [(256, 4096), (1, 16, 4096), (64, 4, 4096), (32, 1), (128, 1),
                (1, 1), (16, 2, 576, 1024), (7,), ()]:
        for lead in (False, True):
            want = ref_shd.batch_spec(shp, ref_mesh, leading_accum=lead)
            got = shd.batch_spec(shp, mesh, leading_accum=lead)
            assert tuple(got) == tuple(want), (shp, lead)


def test_reference_rule_contracts_restated():
    """``tests/test_sharding_dryrun.py``'s ``test_param_rules`` and
    ``test_cache_rules``, against the port."""
    mesh = make_production_mesh(devices="meta")
    P = shd.P

    def leaf(*s):
        return torch.empty(s, device="meta")

    assert shd.param_spec(("embed",), leaf(102400, 5120), mesh) == \
        P("model", "data")
    assert shd.param_spec(("attn", "wq"), leaf(60, 5120, 16384), mesh) == \
        P(None, "data", "model")
    assert shd.param_spec(("attn", "wo"), leaf(60, 16384, 5120), mesh) == \
        P(None, "model", "data")
    assert shd.param_spec(("mlp", "wi"), leaf(60, 160, 5120, 1536), mesh) \
        == P(None, "model", "data", None)
    assert shd.param_spec(("attn", "wq"), leaf(4, 30, 30), mesh) == \
        P(None, None, None)
    assert shd.param_spec(("norm1",), leaf(60, 5120), mesh) == P()
    assert shd.cache_spec(("k",), leaf(40, 128, 32768, 8, 128), mesh) == \
        P(None, ("data",), "model", None, None)
    assert shd.cache_spec(("k",), leaf(24, 1, 524288, 8, 128), mesh) == \
        P(None, None, ("data", "model"), None, None)
    # the spec type follows JAX's: a one-name tuple is the name
    assert tuple(P(None, ("data",))) == (None, "data")
    ns = shd.NamedSharding(mesh, P(None, "model", "data", None))
    assert ns.shard_shape((60, 160, 5120, 1536)) == (60, 10, 320, 1536)
    assert ns.shard_bytes((60, 160, 5120, 1536), torch.bfloat16) == \
        60 * 10 * 320 * 1536 * 2


def _record_constraints(monkeypatch):
    seen = []
    orig_c, orig_k = shard_ctx.constrain_spec, shard_ctx.cache_constrain_spec

    def c(shape, dims, mesh):
        seen.append(("c", tuple(shape), tuple(dims)))
        return orig_c(shape, dims, mesh)

    def k(shape, b, s, mesh):
        seen.append(("k", tuple(shape), (b, s)))
        return orig_k(shape, b, s, mesh)

    monkeypatch.setattr(shard_ctx, "constrain_spec", c)
    monkeypatch.setattr(shard_ctx, "cache_constrain_spec", k)
    return seen


def _ref_constrain(kind, shape, arg, mesh_shape, monkeypatch):
    """The spec the reference's ``constrain`` / ``constrain_cache`` pins."""
    monkeypatch.setattr(ref_ctx, "NamedSharding", _NS)
    monkeypatch.setattr(ref_ctx, "jax", types.SimpleNamespace(
        lax=types.SimpleNamespace(with_sharding_constraint=lambda x, s: s)))
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    with ref_ctx.use_mesh(_FakeMesh(mesh_shape)):
        if kind == "c":
            return tuple(ref_ctx.constrain(x, arg).spec)
        return tuple(ref_ctx.constrain_cache(x, *arg).spec)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_v2_236b",
                                  "zamba2_1_2b", "whisper_tiny",
                                  "phi_3_vision_4_2b"])
def test_constrain_specs_on_the_models_shapes(arch, monkeypatch):
    """Every hint a smoke model's loss, prefill and decode step pins under
    a (2, 4) mesh: the reference's spec, and ``x`` comes back unchanged."""
    seen = _record_constraints(monkeypatch)
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    mesh = make_test_mesh(devices=["cpu"] * 8)
    B, S = 4, 32
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.vlm is not None:
        batch["patches"] = torch.zeros((B, cfg.vlm.n_patches, cfg.vlm.d_patch))
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, S, cfg.d_model))
    model.loss(params, batch, mesh=mesh)
    cache = model.init_cache(B, 64, torch.float32)
    with shard_ctx.use_mesh(mesh):
        model.init_cache(B, 64, torch.float32)
    model.decode_step(params, cache, batch["tokens"][:, :1], 3, mesh=mesh)
    assert seen
    for kind, shape, arg in set(seen):
        want = _ref_constrain(kind, shape, arg, dict(mesh.shape),
                              monkeypatch)
        fn = (shard_ctx.constrain_spec if kind == "c"
              else shard_ctx.cache_constrain_spec)
        got = fn(shape, arg, mesh) if kind == "c" else fn(shape, *arg, mesh)
        assert tuple(got) == want, (kind, shape, arg)
    x = torch.ones(8, 3)
    with shard_ctx.use_mesh(mesh):
        assert shard_ctx.constrain(x, ("dp", None)) is x
        assert shard_ctx.constrain_cache(x, 0, 1) is x


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("shape", [(128, 32768, 8, 128), (1, 524288, 8, 128),
                                   (6, 30, 7, 5), (32, 17, 4, 3)])
def test_constrain_on_production_meshes(shape, mesh_kind, monkeypatch):
    mesh_shape, make = MESHES[mesh_kind]
    mesh = make()
    for dims in [("dp", None, "model", None), ("dp", "model", None, None),
                 (None, None, None, "model")]:
        assert tuple(shard_ctx.constrain_spec(shape, dims, mesh)) == \
            _ref_constrain("c", shape, dims, mesh_shape, monkeypatch)
    for b, s in [(0, 1), (1, 0)]:
        assert tuple(shard_ctx.cache_constrain_spec(shape, b, s, mesh)) == \
            _ref_constrain("k", shape, (b, s), mesh_shape, monkeypatch)


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen2_5_3b", "decode_32k"), ("deepseek_v2_236b", "train_4k"),
    ("whisper_tiny", "prefill_32k"), ("phi_3_vision_4_2b", "train_4k")])
def test_cell_argument_bytes(arch, shape_name, ref_records_specs):
    """A cell's arguments a device (``specs.arg_bytes``) equal the bytes
    the reference's specs give its cell's arguments."""
    shape = MESHES["single"][0]
    cell = build_cell(arch, shape_name, make_production_mesh(devices="meta"))
    ref_mesh = _FakeMesh(shape)
    ref_model, ref_p = ref_params(arch)
    specs = _ref_param_specs(arch, ref_mesh, cell.kind == "decode")
    want = sum(_shard_bytes_from_spec(leaf.shape, leaf.dtype.itemsize,
                                      specs[k], shape)
               for k, leaf in _ref_flat(ref_p).items())
    cfg = ref_configs.get_config(arch)
    if cell.kind == "train":
        ref_opt = jax.eval_shape(ref_adamw_init, ref_p)
        osh = _ref_flat(ref_shd.opt_state_shardings(ref_opt, ref_p, ref_mesh))
        want += sum(_shard_bytes_from_spec(leaf.shape, leaf.dtype.itemsize,
                                           osh[k].spec, shape)
                    for k, leaf in _ref_flat(ref_opt).items())
    if cell.kind == "decode":
        B, S = cell.args[2].shape[0], cell.seq_len
        ref_cache = jax.eval_shape(lambda: ref_model.init_cache(
            B, S, ref_dtype_of(cfg.kv_cache_dtype)))
        csh = _ref_flat(ref_shd.cache_shardings(ref_cache, ref_mesh))
        want += sum(_shard_bytes_from_spec(leaf.shape, leaf.dtype.itemsize,
                                           csh[k].spec, shape)
                    for k, leaf in _ref_flat(ref_cache).items())
        want += _shard_bytes_from_spec((B, 1), 4, ref_shd.batch_spec(
            (B, 1), ref_mesh), shape) + 4
    else:
        batch = cell.args[-1]
        for k, leaf in batch.items():
            spec = ref_shd.batch_spec(tuple(leaf.shape), ref_mesh,
                                      leading_accum=cell.kind == "train")
            want += _shard_bytes_from_spec(tuple(leaf.shape),
                                           leaf.element_size(), spec, shape)
    assert arg_bytes(cell) == want
