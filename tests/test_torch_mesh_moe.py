"""The port's meshed MoE (``repro_torch.models.mlp.moe_forward`` under a
mesh) against the reference's ``shard_map`` branches on 8 host devices.

The reference runs once, in one subprocess (its device count must be set
before ``jax`` is imported): granite-moe's f32 smoke config under
``make_test_mesh()`` (data 2, model 4).  Its parameters and outputs come
back as numpy arrays; the parameters cross into the port through
``convert.model_params_from_arrays``, which runs under a logical (2, 4)
mesh of the CPU.  Held at 2e-5 of the reference's largest magnitude (f32
products and sums in another order):

* ``moe_forward``'s weight-stationary branch (8 tokens), its
  token-sharded branch (1,040 tokens: above 1,024), the token-sharded
  branch on an indivisible ``d_ff_expert`` (33) with tokens split over
  the data shards (8) and replicated (7);
* granite-moe's ``decode_step`` (3 steps) and ``loss`` (both branches)
  under the mesh, and one microbatch's gradients.

In f32 a shard's partial rounds to itself, so those checks cannot see
which shard a contribution is summed on; each shard's partial of the
port's grid (``mlp._routed``) is therefore held, in f32 and bf16, against
the one-shard ``_routed_local`` on that shard's slice of the weights, and
that against the reference's ``_routed_local`` of the same shard.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as ref_mlp

from repro_torch import configs
from repro_torch.convert import model_params_from_arrays
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import mlp
from repro_torch.models.api import build_model, value_and_grad
from repro_torch.models.common import tree_map
from repro_torch.models.shard_ctx import recording_collectives

TOL = 2e-5
BF16_TOL = 6e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite_moe_3b_a800m"
#: moe_forward cases: (name, batch, seq, d_ff_expert or None)
MOE_CASES = (("weight_stationary", 2, 4, None),
             ("token_sharded", 2, 520, None),
             ("indivisible_ff_split", 2, 4, 33),
             ("indivisible_ff_replicated", 1, 7, 33))
LOSS_CASES = (("loss_weight_stationary", 2, 8), ("loss_token_sharded", 4, 300))
DECODE = (4, 16, 3)            # rows, cache positions, steps

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
import dataclasses, functools, json
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.models import mlp
from repro.models.api import build_model
from repro.launch.mesh import make_test_mesh

spec = json.loads(sys.argv[2])
out = {}
mesh = make_test_mesh()
assert dict(mesh.shape) == {"data": 2, "model": 4}, mesh.shape


def f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        out[prefix] = np.asarray(tree)


base = f32(configs.get_smoke_config(spec["arch"]))
rng = np.random.default_rng(0)
for name, B, S, ff in spec["moe"]:
    cfg = base if ff is None else dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, d_ff_expert=ff))
    params = build_model(cfg).init(jax.random.PRNGKey(1))
    lp = jax.tree.map(lambda a: a[0], params["layers"]["mlp"])
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    y, aux = jax.jit(functools.partial(mlp.moe_forward, cfg=cfg,
                                       mesh=mesh))(lp, jnp.asarray(x))
    put(name + "/params", lp)
    out[name + "/x"], out[name + "/y"] = x, np.asarray(y)
    out[name + "/aux"] = np.asarray(aux)

model = build_model(base)
params = model.init(jax.random.PRNGKey(0))
put("model", params)
loss_grad = jax.jit(jax.value_and_grad(
    lambda p, b: model.loss(p, b, mesh=mesh)))
for name, B, S in spec["loss"]:
    toks = rng.integers(0, base.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, grads = loss_grad(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    out[name + "/tokens"], out[name + "/labels"] = batch["tokens"], \
        batch["labels"]
    out[name + "/loss"] = np.asarray(loss)
    put(name + "/grads", grads)

B, S, steps = spec["decode"]
cache = model.init_cache(B, S, jnp.float32)
step = jax.jit(functools.partial(model.decode_step, mesh=mesh))
for i in range(steps):
    tok = rng.integers(0, base.vocab, (B, 1)).astype(np.int32)
    logits, cache = step(params, cache, jnp.asarray(tok), jnp.int32(i))
    out[f"decode/{i}/tokens"] = tok
    out[f"decode/{i}/logits"] = np.asarray(logits)
put("decode/cache", cache)
np.savez(sys.argv[1], **out)
print("ok")
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_moe") / "ref.npz"
    spec = json.dumps({"arch": ARCH, "moe": MOE_CASES, "loss": LOSS_CASES,
                       "decode": DECODE})
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REF, str(path), spec],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def tree(ref: dict, prefix: str) -> dict:
    """The nested dict of the arrays under ``prefix/``."""
    out: dict = {}
    for key, v in ref.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *parts, last = key[len(prefix) + 1:].split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def f32_cfg(ff=None):
    cfg = configs.get_smoke_config(ARCH)
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    if ff is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=ff))
    return cfg


@pytest.fixture(scope="module")
def mesh():
    return make_test_mesh(devices=["cpu"] * 8)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def gap(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name,B,S,ff", MOE_CASES)
def test_moe_forward_branches(ref, mesh, name, B, S, ff):
    cfg = f32_cfg(ff)
    p = {k: torch.from_numpy(v) for k, v in tree(ref, name + "/params").items()}
    x = torch.from_numpy(ref[name + "/x"])
    with recording_collectives() as log:
        y, aux = mlp.moe_forward(p, x, cfg, mesh=mesh)
    assert gap(y, ref[name + "/y"]) <= TOL
    assert gap(aux, ref[name + "/aux"]) <= TOL
    want = ("moe_weight_stationary" if name == "weight_stationary"
            else "moe_token_sharded")
    assert [r.what for r in log] == [want]
    T, d = B * S, cfg.d_model
    if name == "weight_stationary":
        assert (log[0].out_bytes, log[0].group) == (T * d * 4, 8)
    elif name == "indivisible_ff_replicated":
        assert (log[0].out_bytes, log[0].group) == (T * d * 4, 4)
    else:
        assert (log[0].out_bytes, log[0].group) == (T // 2 * d * 4, 4)


def test_meshed_capacity_drops_other_tokens(ref, mesh):
    """The token-sharded branch's per-shard capacity is the reference's:
    the meshed output differs from the unmeshed one (other drops)."""
    cfg = f32_cfg()
    p = {k: torch.from_numpy(v) for k, v in
         tree(ref, "token_sharded/params").items()}
    x = torch.from_numpy(ref["token_sharded/x"])
    meshed, _ = mlp.moe_forward(p, x, cfg, mesh=mesh)
    plain, _ = mlp.moe_forward(p, x, cfg)
    assert not torch.equal(meshed, plain)
    one = make_test_mesh(devices=["cpu"])          # model axis 1: no split
    assert torch.equal(mlp.moe_forward(p, x, cfg, mesh=one)[0], plain)


@pytest.fixture(scope="module")
def port_model(ref):
    cfg = f32_cfg()
    model = build_model(cfg, device="cpu")
    params = model_params_from_arrays(cfg, tree(ref, "model"), device="cpu")
    return model, params


@pytest.mark.parametrize("name,B,S", LOSS_CASES)
def test_loss_and_gradients_under_the_mesh(ref, mesh, port_model, name, B, S):
    model, params = port_model
    batch = {k: torch.from_numpy(ref[f"{name}/{k}"])
             for k in ("tokens", "labels")}
    assert gap(model.loss(params, batch, mesh=mesh), ref[name + "/loss"]) \
        <= TOL
    loss, grads = value_and_grad(model, params, batch, mesh=mesh)
    assert gap(loss, ref[name + "/loss"]) <= TOL
    want = tree(ref, name + "/grads")
    flat = []
    tree_map(lambda g, w: flat.append((gap(g, w), g.shape)), grads,
             tree_map(lambda w: w, want))
    assert flat and max(g for g, _ in flat) <= TOL, flat


def test_decode_steps_under_the_mesh(ref, mesh, port_model):
    model, params = port_model
    B, S, steps = DECODE
    cache = model.init_cache(B, S, torch.float32)
    with recording_collectives() as log:
        for i in range(steps):
            tok = torch.from_numpy(ref[f"decode/{i}/tokens"])
            logits, cache = model.decode_step(params, cache, tok, i,
                                              mesh=mesh)
            assert gap(logits, ref[f"decode/{i}/logits"]) <= TOL
    want = tree(ref, "decode/cache")
    tree_map(lambda c, w: _assert_close(c, w), cache, want)
    L = model.cfg.n_layers
    assert [r.what for r in log] == ["moe_weight_stationary"] * (L * steps)


def _assert_close(got, want):
    assert gap(got, want) <= TOL


def test_train_step_under_the_mesh(mesh, port_model):
    """``make_train_step(mesh=)`` is the unmeshed step's computation on
    the meshed loss: its loss is ``accumulate_gradients``' under the mesh,
    and ``make_eval_step(mesh=)`` gives the meshed loss."""
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig, adamw_init

    model, params = port_model
    rng = np.random.default_rng(3)
    toks = rng.integers(0, model.cfg.vocab, (2, 2, 41)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    loss, g = train.accumulate_gradients(model, params, batch, mesh=mesh)
    p = tree_map(lambda a: a.clone(), params)
    _, _, stats = train.make_train_step(model, AdamWConfig(), mesh=mesh)(
        p, adamw_init(p), batch)
    assert float(stats["loss"]) == float(loss)
    ev = train.make_eval_step(model, mesh=mesh)
    mean = sum(float(ev(params, {k: v[i] for k, v in batch.items()}))
               for i in range(2)) / 2
    assert abs(mean - float(loss)) <= 1e-6 * abs(float(loss))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,J", [(4, 2), (4, 1), (2, 4)])
def test_each_shard_is_the_per_shard_routed_local(M, J, dtype):
    rng = np.random.default_rng(11)
    G, T, d, f, E, k, C = 2, 12, 16, 8, 16, 2, 3
    x = rng.standard_normal((G, T, d)).astype(np.float32)
    # skewed routing so capacity 3 drops assignments
    idx = np.stack([np.stack([rng.choice(4 if t % 2 else E, size=k,
                                         replace=False) for t in range(T)])
                    for _ in range(G)]).astype(np.int64)
    w = rng.random((G, T, k)).astype(np.float32)
    wi, wg = (rng.standard_normal((E, d, f)).astype(np.float32) for _ in "ab")
    wo = rng.standard_normal((E, f, d)).astype(np.float32)
    tx, tw, twi, twg, two = (torch.from_numpy(a).to(dtype)
                             for a in (x, w, wi, wg, wo))
    parts = mlp._routed(tx, torch.from_numpy(idx), tw, twi, twg, two, e0=0,
                        capacity=C, model_shards=M, ff_shards=J)
    assert parts.shape == (M, G, J, T, d) and parts.dtype == dtype
    # G groups in one product round differently from one group alone
    tol = TOL if dtype == torch.float32 else BF16_TOL
    e_l, f_l = E // M, f // J
    for g in range(G):
        for i in range(M):
            es = slice(i * e_l, (i + 1) * e_l)
            for j in range(J):
                fs = slice(j * f_l, (j + 1) * f_l)
                shard = (twi[es, :, fs], twg[es, :, fs], two[es, fs, :])
                want = mlp._routed_local(
                    tx[g], torch.from_numpy(idx[g]), tw[g], *shard,
                    n_experts=E, n_shards=M, shard_id=i, capacity=C)
                assert gap(parts[i, g, j], want) <= tol, (g, i, j)
                if dtype == torch.float32:
                    ref = ref_mlp._routed_local(
                        jnp.asarray(x[g]), jnp.asarray(idx[g]),
                        jnp.asarray(w[g]), *(jnp.asarray(a.numpy())
                                             for a in shard),
                        n_experts=E, n_shards=M, shard_id=i, capacity=C)
                    assert gap(want, np.asarray(ref)) <= TOL
