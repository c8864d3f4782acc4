"""The port's ``BatchedServer`` against ``repro.serving.BatchedServer``, on the CPU.

* token streams: the f32 smoke variants of qwen2.5, granite-moe,
  deepseek-v2 (MLA), whisper (encoder-decoder), zamba2 (SSM hybrid) and
  xlstm serve the same requests to the same tokens in both packages (the
  same ``batch_size``, ``cache_len`` and ``max_new``; the reference's
  jitted step against the port's eager one, both over a bf16 cache, or an
  f32 one for deepseek-v2: MLA writes its latent rows uncast, so an f32
  model refuses a bf16 cache in both packages);
* staggered arrivals decode as their solo runs, and a reused slot
  restarts at position 0 with a zeroed recurrent state (the port's
  counterparts of ``tests/test_server_staggered.py``), for every smoke
  config;
* the routing tap feeding the port's ``ExpertCacheManager(device="cpu")``
  gives the reference manager's cliques and totals (1e-9) when the
  reference is fed the same top-k, for granite-moe and deepseek-v2 (its
  first MoE layer after the dense prefix);
* ``launch.serve --local`` and the example module run on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models.api import build_model as ref_build
from repro.serving import BatchedServer as RefServer
from repro.serving import Request as RefRequest
from repro.serving.expert_cache import ExpertCacheManager as RefManager

from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.examples import serve_moe_expert_cache as example
from repro_torch.kernels import packed_lookup_plain
from repro_torch.launch import serve as launch_serve
from repro_torch.models.api import build_model
from repro_torch.serving import BatchedServer, Request

DECODERS = ["qwen2_5_3b", "codeqwen1_5_7b", "h2o_danube_1_8b",
            "command_r_35b", "granite_moe_3b_a800m", "phi_3_vision_4_2b"]
#: the families of the second model slice
FAMILIES = ["deepseek_v2_236b", "whisper_tiny", "zamba2_1_2b", "xlstm_125m"]
#: relative tolerance of the expert cache's float costs (the reference's bar)
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread: at the smoke sizes every op is tiny,
    and under the parallel test run an op's thread team waits on cores the
    other workers hold (a test here ran ~50x slower on 8 loaded cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree.astype(np.float32) if tree.dtype.name == "bfloat16"
                      else tree)


def f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def prompts(seed: int, n: int, vocab: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(2, 7)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "granite_moe_3b_a800m"]
                         + FAMILIES)
def test_token_streams_equal_the_reference(arch):
    rcfg, tcfg = f32(ref_smoke(arch)), f32(get_smoke_config(arch))
    rm = ref_build(rcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = model_params_from_arrays(tcfg, np_tree(rp), device="cpu")
    ps = prompts(1, 7, rcfg.vocab)
    rs = RefServer(rm, rp, batch_size=3, cache_len=32)
    ts = BatchedServer(tm, tp, batch_size=3, cache_len=32)
    if tcfg.mla is not None:
        # the latent rows are written in the compute dtype, uncast: an f32
        # model refuses the server's bf16 cache in both packages
        ts.submit(Request(rid=0, prompt=[1, 2], max_new=1))
        with pytest.raises(TypeError, match="cache rows"):
            ts.run(max_steps=2)
        rs.cache = rm.init_cache(3, 32, jnp.float32)
        ts = BatchedServer(tm, tp, batch_size=3, cache_len=32)
        ts.cache = tm.init_cache(3, 32, torch.float32)
    for rid, pr in enumerate(ps):
        rs.submit(RefRequest(rid=rid, prompt=list(pr), max_new=6))
        ts.submit(Request(rid=rid, prompt=list(pr), max_new=6))
    want = {r.rid: r.out for r in rs.run(max_steps=200)}
    got = {r.rid: r.out for r in ts.run(max_steps=200)}
    assert len(got) == len(ps)
    assert got == want
    assert ts.steps == rs.steps


def _model(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    return model, model.init(0)


def _run_solo(model, params, prompt, max_new=6):
    srv = BatchedServer(model, params, batch_size=2, cache_len=64)
    srv.submit(Request(rid=0, prompt=list(prompt), max_new=max_new))
    done = srv.run(max_steps=200)
    assert len(done) == 1
    return done[0].out


@pytest.mark.parametrize("arch", DECODERS + FAMILIES)
def test_staggered_arrival_matches_solo_decode(arch):
    model, params = _model(arch)
    p0 = [1, 2, 3, 4, 5, 6, 7, 8]
    p1 = [9, 8, 7]
    solo0 = _run_solo(model, params, p0)
    solo1 = _run_solo(model, params, p1)

    srv = BatchedServer(model, params, batch_size=2, cache_len=64)
    srv.submit(Request(rid=0, prompt=list(p0), max_new=6))
    for _ in range(4):                 # r0 is 4 tokens deep when r1 arrives
        srv.step()
    srv.submit(Request(rid=1, prompt=list(p1), max_new=6))
    done = {r.rid: r for r in srv.run(max_steps=200)}
    assert set(done) == {0, 1}
    assert done[0].out == solo0, "co-scheduling changed request 0's output"
    assert done[1].out == solo1, "staggered request decoded at wrong position"


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "granite_moe_3b_a800m",
                                  "zamba2_1_2b", "xlstm_125m"])
def test_slot_reuse_restarts_position(arch):
    """A reused slot decodes its next request from position 0; a recurrent
    arch's state is zeroed on admission, so the request gives its solo
    tokens (the previous tenant's state would leak otherwise)."""
    model, params = _model(arch)
    short, late = [4, 5], [11, 12, 13]
    solo = _run_solo(model, params, late, max_new=4)
    srv = BatchedServer(model, params, batch_size=1, cache_len=64)
    srv.submit(Request(rid=0, prompt=list(short), max_new=2))
    srv.submit(Request(rid=1, prompt=list(late), max_new=4))
    done = {r.rid: r for r in srv.run(max_steps=200)}
    assert set(done) == {0, 1}
    assert done[1].out == solo


def test_eos_stops_a_request():
    model, params = _model("qwen2_5_3b")
    first = _run_solo(model, params, [3, 4, 5], max_new=6)
    eos = first[-1]
    srv = BatchedServer(model, params, batch_size=2, cache_len=64,
                        eos_id=eos)
    srv.submit(Request(rid=0, prompt=[3, 4, 5], max_new=6))
    (done,) = srv.run(max_steps=100)
    assert done.out == first[:first.index(eos) + 1]


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_v2_236b"])
def test_routing_tap_feeds_the_same_expert_cache(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    reqs = example.make_requests(np.random.default_rng(0), 24, cfg.vocab, 2,
                                 6, 8)
    srv, mgr, done, topks = example.serve_with_expert_cache(
        model, params, reqs, batch_size=4, cache_len=64, max_steps=500)
    assert len(done) == 24 and len(topks) == srv.steps
    assert all(t.shape == (4, cfg.moe.top_k) for t in topks)
    ref = RefManager(n_experts=cfg.moe.n_experts, n_hosts=2, t_cg=24.0,
                     backend="session")
    for t in topks:
        ref.observe(t, host=0)
    got, want = mgr.stats(), ref.stats()
    assert [tuple(map(int, c)) for c in got.cliques] == \
        [tuple(map(int, c)) for c in want.cliques]
    assert got.n_observations == want.n_observations
    np.testing.assert_allclose(got.akpc_total, want.akpc_total, rtol=RTOL)
    np.testing.assert_allclose(got.nopack_total, want.nopack_total, rtol=RTOL)
    # the tap is the router's top-k of the embeddings, as the reference's
    emb = params["embed"].float().numpy()
    router0 = params["layers"]["mlp"]["router"][0].numpy()
    toks = np.zeros((4, 1), np.int32)
    toks[:, 0] = [1, 2, 3, 4]
    rec: list = []
    example.routing_tap(params, cfg, RefManager(cfg.moe.n_experts, 2),
                        record=rec)(params, toks)
    want_sets = np.sort(np.argsort(-(emb[toks[:, 0]] @ router0),
                                   axis=-1)[:, :cfg.moe.top_k], axis=-1)
    assert np.array_equal(np.sort(rec[0], axis=-1), want_sets)
    # the gather of the last step's cliques is the host table's rows
    g = example.expert_gather(mgr, params, topks[-1])
    table, where = ref.packed_tables(
        params["layers"]["mlp"]["wi"][0].reshape(
            cfg.moe.n_experts_padded, -1).float().numpy())
    assert torch.equal(g["table"].float(), torch.from_numpy(table))
    assert np.array_equal(g["where"], where)
    assert torch.equal(g["rows"], packed_lookup_plain(g["table"], g["ids"]))
    assert g["rows"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b",
                                  "whisper-tiny", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_launch_serve_local_on_cpu(arch, capsys):
    done = launch_serve.main(["--arch", arch, "--local", "--device", "cpu"])
    assert len(done) == 8 and all(len(r.out) == 8 for r in done)
    assert "served 8 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_v2_236b"])
def test_example_on_cpu(arch, capsys):
    out = example.main(["--device", "cpu", "--arch", arch])
    assert out["server"].steps > 0 and out["stats"].n_observations > 0
    text = capsys.readouterr().out
    assert "served 24 requests" in text and "packed table" in text
