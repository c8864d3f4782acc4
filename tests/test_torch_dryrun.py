"""The dry run (``repro_torch.launch.dryrun`` / ``specs`` / ``cost_analysis``)
against the reference's ``launch/hlo_analysis.py`` contracts.

* ``tests/test_hlo_analysis.py``'s contracts, restated: 10 chained
  128-square products count 10 * 2 * 128**3 FLOPs (the eager loop counts
  every trip), one 64x32x16 product exactly 2 * 64 * 32 * 16, and the ring
  formulas give the reference's wire bytes on its own HLO snippet;
* the FLOPs of every family's smoke-config loss (traced on meta tensors)
  within 2% of the reference's ``analyze_hlo`` of the same loss compiled
  on one CPU device (the gap printed);
* ``run_cell`` gives ``ok`` on a small cell and ``skipped`` for
  ``long_500k`` on a full-attention config; the CLI appends and skips
  what is done; ``serve --dry`` and the ``roofline`` suite read them.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro import configs as ref_configs
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.api import build_model as ref_build

from repro_torch import configs
from repro_torch.bench import common as bench_common
from repro_torch.bench import run as bench_run
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.specs import (
    arg_bytes,
    build_cell,
    instantiate_cell,
    trace_cell,
)
from repro_torch.models.api import build_model

FLOPS_RTOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_chained_products_count_every_trip():
    a = _meta(128, 128)

    def chain(a):
        c = a
        for _ in range(10):
            c = c @ a
        return c

    _, cost = ca.trace(chain, a)
    assert cost.flops == 10 * 2 * 128 ** 3


def test_single_matmul_flops():
    _, cost = ca.trace(lambda a, b: a @ b, _meta(64, 32), _meta(32, 16))
    assert cost.flops == 2 * 64 * 32 * 16
    # operands and result of the product cross HBM; the add is fused
    _, cost = ca.trace(lambda a, b: (a @ b) + 1.0, _meta(64, 32),
                       _meta(32, 16))
    assert cost.hbm_bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)


HLO = """
HloModule m

ENTRY %main.1 (p: f32[16,16]) -> f32[16,16] {
  %p = f32[16,16]{1,0} parameter(0)
  %ar = f32[16,16]{1,0} all-reduce(%p), replica_groups=[2,4]<=[8], to_apply=%add
  ROOT %ag = f32[16,16]{1,0} all-gather(%ar), replica_groups={{0,1},{2,3},{4,5},{6,7}}, dimensions={0}
}
"""


def test_collective_wire_bytes():
    st = analyze_hlo(HLO, 8)
    b = 16 * 16 * 4
    assert ca.ring_wire_bytes("all-reduce", b, 4) == \
        st.coll_bytes_by_kind["all-reduce"] == 2 * b * 3 / 4
    assert ca.ring_wire_bytes("all-gather", b, 2) == \
        st.coll_bytes_by_kind["all-gather"] == b * 1 / 2
    assert ca.ring_wire_bytes("reduce-scatter", b, 4) == b * 3
    assert ca.ring_wire_bytes("all-reduce", b, 1) == 0.0


def test_temporary_peak_and_hbm_bytes():
    """The peak counts the storages the call creates while they live."""
    x = _meta(1024, 256)

    def fn(x):
        a = x.clone()                 # 1 MiB
        b = a.clone()                 # 1 MiB: 2 MiB live
        del a
        c = b.sum(0)                  # 1 KiB
        return c

    _, cost = ca.trace(fn, x)
    mib = 1024 * 256 * 4
    assert cost.peak_bytes == 2 * mib
    # two clones (operand + result) and the sum (operand + result)
    assert cost.hbm_bytes == 2 * 2 * mib + mib + 256 * 4


def _batch(cfg, B, S, rng, meta: bool):
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.vlm is not None:
        batch["patches"] = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.d_patch)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if meta:
        return {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                               device="meta") for k, v in batch.items()}
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_loss_flops_against_analyze_hlo(arch):
    cfg = ref_configs.get_smoke_config(arch)
    rec = cfg.ssm or cfg.xlstm
    S = 2 * rec.chunk if rec else 32
    rng = np.random.default_rng(0)
    rm = ref_build(cfg)
    rp = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
    rb = _batch(cfg, 2, S, rng, meta=False)
    txt = jax.jit(rm.loss).lower(rp, rb).compile().as_text()
    want = analyze_hlo(txt, 1).flops
    tm = build_model(configs.get_smoke_config(arch), device="meta")
    _, cost = ca.trace(tm.loss, tm.init(0),
                       _batch(cfg, 2, S, np.random.default_rng(0), meta=True))
    gap = abs(cost.flops - want) / want
    print(f"{arch}: traced {cost.flops:.6g} FLOPs, analyze_hlo {want:.6g}, "
          f"gap {gap:.4%}")
    assert gap <= FLOPS_RTOL


def test_run_cell_ok_and_skipped():
    rec = dryrun.run_cell("whisper_tiny", "decode_32k", "single")
    assert rec["status"] == "ok", rec
    for key in ("arg_bytes", "temp_bytes", "out_bytes", "live_bytes_per_dev",
                "fits_hbm", "flops_per_dev", "hbm_bytes_per_dev",
                "coll_bytes_per_dev", "coll_by_kind", "coll_counts",
                "compute_s", "memory_s", "collective_s", "dominant",
                "model_flops", "useful_flops_ratio", "roofline_fraction"):
        assert key in rec, key
    assert rec["fits_hbm"] and rec["live_bytes_per_dev"] == \
        rec["arg_bytes"] + rec["temp_bytes"]
    assert rec["dominant"] in ("compute", "memory", "collective")
    # a decode cell: FSDP gathers of the data-sharded weights, once each
    assert set(rec["coll_by_kind"]) == {"all-gather"}
    skipped = dryrun.run_cell("qwen2_5_3b", "long_500k", "single")
    assert skipped["status"] == "skipped"
    assert dryrun.run_cell("zamba2_1_2b", "long_500k", "single")[
        "status"] != "skipped"


def test_train_cell_collectives_and_accum():
    """A train cell traces one microbatch: its FLOPs times ``accum`` plus
    the update's, and the modelled collectives of both halves."""
    mesh = make_production_mesh(devices="meta")
    cell = build_cell("whisper_tiny", "train_4k", mesh)
    cost = trace_cell(cell)
    accum = cell.static["accum"]
    assert cell.static == {"accum": accum, "microbatch": 256 // accum}
    # AdamW's update has no products
    assert cost.flops == cost.flops_once * accum
    assert set(cost.collectives.bytes) == {"all-gather", "reduce-scatter",
                                           "all-reduce"}
    batch, bshard = cell.args[2], cell.shardings[2]
    assert cost.alias_bytes == arg_bytes(cell) - sum(
        bshard[k].shard_bytes(v.shape, v.dtype) for k, v in batch.items())


def test_instantiated_cell_runs_on_the_cpu():
    """A cut decode cell made real: the tensors' bytes are the dry run's
    argument bytes, and the step runs meshed and finite."""
    kw = dict(global_batch=2, seq_len=32)
    mesh = make_test_mesh(devices=["cpu"] * 8)
    cell = build_cell("whisper_tiny", "decode_32k", mesh, **kw)
    one = build_cell("whisper_tiny", "decode_32k",
                     make_test_mesh(devices=["cpu"]), **kw)
    real = instantiate_cell(one, "cpu", seed=0)
    assert sum(t.numel() * t.element_size()
               for t in tree_leaves(real.args)) == arg_bytes(one)
    assert arg_bytes(cell) < arg_bytes(one)
    real = instantiate_cell(cell, "cpu", seed=0)
    logits, cache = real.step_fn(*real.args)
    assert logits.shape == (2, 1, cell.cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())


def test_cli_appends_and_skips(tmp_path, capsys):
    out = tmp_path / "dryrun.jsonl"
    argv = ["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(out)]
    recs = dryrun.main(argv)
    assert [r["status"] for r in recs] == ["ok"]
    assert dryrun.main(argv) == []
    assert "[skip-done]" in capsys.readouterr().out
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k", "--mesh",
                 "single", "--out", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(r["arch"], r["status"]) for r in lines] == [
        ("whisper_tiny", "ok"), ("qwen2_5_3b", "skipped")]


def test_serve_dry_and_roofline_suite(tmp_path, monkeypatch, capsys):
    got = launch_serve.main(["--arch", "whisper-tiny", "--dry"])
    assert set(got) == {"status", "dominant", "roofline_fraction",
                        "fits_hbm"} and got["status"] == "ok"
    out = tmp_path / "dryrun.jsonl"
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(out)])
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(out)])
    monkeypatch.setenv("REPRO_DRYRUN", str(out))
    monkeypatch.setattr(bench_common, "RESULTS_DIR", str(tmp_path))
    capsys.readouterr()
    assert bench_run.main(["roofline", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "roofline/whisper_tiny/decode_32k,0,dom=" in text
    assert "roofline/qwen2_5_3b/long_500k,0,N/A(sub-quadratic-only)" in text
    assert "suite/roofline," in text and "done" in text
    payload = json.loads((tmp_path / "roofline_report_torch.json").read_text())
    assert payload == {"n_ok": 1, "n_skipped": 1}


def test_hardware_constants_are_the_h100s():
    assert ca.PEAK_FLOPS == 989e12 and ca.HBM_BW == 3.35e12
    assert ca.LINK_BW == 450e9 and ca.HBM_PER_DEVICE == 80e9
    rl = ca.make_roofline(989e12, 3.35e12, 450e9, 1, 989e12)
    assert (rl.compute_s, rl.memory_s, rl.collective_s) == (1.0, 1.0, 1.0)
    assert rl.roofline_fraction == 1.0 and rl.useful_flops_ratio == 1.0


def test_dry_mesh_holds_no_device():
    mesh = make_production_mesh(multi_pod=True, devices="meta")
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512 and mesh.physical_devices == 1
    assert mesh.home.type == "meta"
    with pytest.raises(ValueError):
        make_production_mesh(devices=["meta"] * 3)
    assert dataclasses.is_dataclass(build_cell("xlstm_125m", "decode_32k",
                                               mesh))
