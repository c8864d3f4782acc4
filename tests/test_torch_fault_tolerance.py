"""The port's checkpoints and fault tolerance, on the CPU.

``tests/test_checkpoint.py``'s four contracts on the port's trees (torch
tensors of bf16, f32, int8 and int32, restored into a ``like`` tree; the
commit marker; the manager's keep-N collection and asynchronous save; a
mismatched tree refused), and ``tests/test_fault_tolerance.py``'s on the
port's ``TrainController``: the final parameters after an injected
failure and restart are bitwise those of an uninterrupted run, and the
straggler policies' logs equal ``repro``'s for equal seeds.  Last,
``python -m repro_torch.examples.train_lm`` at a tiny size.
"""
import os

import numpy as np
import pytest
import torch

from repro.distributed import FailureInjector as RefInjector
from repro.distributed import StragglerPolicy as RefStraggler

from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    load_checkpoint_tree,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.data import PackedDataPipeline, ShardStore, TokenBatcher
from repro_torch.distributed import (
    FailureInjector,
    StragglerPolicy,
    TrainController,
    WorkerFailure,
)
from repro_torch.examples import train_lm
from repro_torch.launch.train import make_train_step
from repro_torch.models.api import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, ef_init
from repro_torch.optim.adamw8bit import adamw8bit_init

CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
                  n_kv_heads=2, d_ff=64, vocab=128, tie_embeddings=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread (tiny ops; see test_torch_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": {"w": torch.ones((4,), dtype=torch.bfloat16) * 1.5,
              "step": torch.tensor(7, dtype=torch.int32),
              "q": torch.tensor([-127, 0, 5, 127], dtype=torch.int8)},
    }


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype and got[k].device == \
                want[k].device, k
            assert torch.equal(got[k], want[k]), k


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 3, t, meta={"note": "x"})
    restored, meta = restore_checkpoint(tmp_path, 3, t)
    assert meta["note"] == "x"
    _assert_same(restored, t)
    # bf16 is stored widened to f32, int8 as it is
    stored, _ = load_checkpoint_tree(tmp_path, 3)
    assert stored["b"]["w"].dtype == np.float32
    assert stored["b"]["q"].dtype == np.int8
    # the like tree decides dtypes and placement
    like = {"a": torch.zeros((2, 3), dtype=torch.float64),
            "b": {"w": torch.zeros(4), "step": np.zeros((), np.int64),
                  "q": torch.zeros(4, dtype=torch.int8)}}
    back, _ = restore_checkpoint(tmp_path, 3, like, device="cpu")
    assert back["a"].dtype == torch.float64
    assert back["b"]["w"].dtype == torch.float32
    assert back["b"]["step"].dtype == np.int64 and int(back["b"]["step"]) == 7


def test_numpy_trees_still_load(tmp_path):
    tree = {"engine": {"E": np.arange(6.0).reshape(3, 2),
                       "anchor": np.array([1, 2, 3], np.int32)},
            "now": np.float64(4.5)}
    save_checkpoint(tmp_path, 1, tree)
    got, meta = load_checkpoint_tree(tmp_path, 1)
    assert meta == {}
    np.testing.assert_array_equal(got["engine"]["E"], tree["engine"]["E"])
    assert got["engine"]["anchor"].dtype == np.int32
    with pytest.raises(FileExistsError):
        save_checkpoint(tmp_path, 1, tree)


def test_commit_marker_protects_torn_writes(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    os.makedirs(tmp_path / "step_00000002")        # no marker: torn write
    assert latest_step(tmp_path) == 1


@pytest.mark.parametrize("async_save", [True, False])
def test_manager_gc_and_async(tmp_path, async_save):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=async_save)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
        t["a"].add_(1.0)          # in-place after save: the snapshot holds
    mgr.wait()
    assert latest_step(tmp_path) == 4
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert len(steps) == 2
    step, back, _ = mgr.restore_latest(_tree())
    assert step == 4
    assert torch.equal(back["a"], torch.arange(6.0).reshape(2, 3) + 3.0)
    assert CheckpointManager(tmp_path / "none").restore_latest(t) == \
        (None, None, None)


def test_structure_mismatch_rejected(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    with pytest.raises(AssertionError):
        restore_checkpoint(tmp_path, 1, {"different": torch.zeros(1)})


def test_optimizer_states_roundtrip(tmp_path):
    """AdamW, 8-bit AdamW and error-feedback states of bf16 parameters."""
    params = build_model(CFG, device="cpu").init(0)
    state = {"params": params, "adamw": adamw_init(params),
             "8bit": {**adamw8bit_init(params), "ef": ef_init(params)}}
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(5, state)
    step, back, _ = mgr.restore_latest(state)
    assert step == 5
    _assert_same(back, state)
    assert back["8bit"]["mv"]["embed"]["m_q"].dtype == torch.int8


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------
def _controller(tmp, steps_at=(), mode=(False, False)):
    model = build_model(CFG, device="cpu")
    store = ShardStore(n_shards=16, shard_tokens=256, vocab=128, n_domains=4)
    pipe = PackedDataPipeline(store, batch_rows=4, seq_len=32, device="cpu")
    batcher = TokenBatcher(pipe, accum=2, microbatch=2)
    compress, opt_8bit = mode
    ts = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=50),
                         compress=compress, opt_8bit=opt_8bit)

    def init_state():
        p = model.init(0)
        opt = adamw8bit_init(p) if opt_8bit else adamw_init(p)
        if compress:
            opt["ef"] = ef_init(p)
        return p, opt

    return TrainController(ts, init_state, batcher, tmp, ckpt_every=4,
                           injector=FailureInjector(at_steps=steps_at))


@pytest.mark.parametrize("mode", [(False, False), (True, True)],
                         ids=["adamw", "compress_8bit"])
def test_recovery_bitwise_identical(tmp_path, mode):
    p1, o1 = _controller(tmp_path / "a", mode=mode).run(total_steps=12)
    ctl = _controller(tmp_path / "b", steps_at=(6,), mode=mode)
    p2, o2 = ctl.run(total_steps=12)
    assert ctl.restarts == 1
    for a, b in zip(tree_leaves(p1) + tree_leaves(o1),
                    tree_leaves(p2) + tree_leaves(o2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [h["step"] for h in ctl.history] == list(range(1, 7)) + list(
        range(5, 13))


def test_failure_injector_equals_reference():
    for kw in ({"at_steps": (3, 9)}, {"p_fail": 0.3, "seed": 4}):
        ref, port = RefInjector(**kw), FailureInjector(**kw)
        for step in list(range(20)) * 2:
            fired = []
            for inj in (ref, port):
                try:
                    inj.check(step)
                    fired.append(False)
                except Exception as e:       # the packages' own classes
                    fired.append(type(e).__name__ == "WorkerFailure")
            assert fired[0] == fired[1], (kw, step)
    assert issubclass(WorkerFailure, RuntimeError)


def test_straggler_policies():
    for mode in ("wait", "skip", "backup"):
        sp = StragglerPolicy(mode=mode, p_straggle=0.3, seed=1)
        ref = RefStraggler(mode=mode, p_straggle=0.3, seed=1)
        times = [sp.step_time(s) for s in range(50)]
        assert times == [ref.step_time(s) for s in range(50)]
        assert sp.log == ref.log
        assert all(t > 0 for t in times)
    wait = StragglerPolicy(mode="wait", p_straggle=0.3, seed=1)
    backup = StragglerPolicy(mode="backup", p_straggle=0.3, seed=1)
    t_wait = sum(wait.step_time(s) for s in range(100))
    t_backup = sum(backup.step_time(s) for s in range(100))
    assert t_backup < t_wait


def test_train_lm_example(tmp_path):
    """The example at a tiny size with a failure after its first checkpoint
    (every 25 steps): restarts once, ends on the uninterrupted run's
    parameters, counts the windows of both cache sessions."""
    argv = ["--device", "cpu", "--steps", "30", "--width", "32", "--layers",
            "1", "--seq", "16", "--vocab", "256"]
    clean = train_lm.run(train_lm.parse(argv + ["--ckpt-dir",
                                                str(tmp_path / "a")]))
    hurt = train_lm.main(argv + ["--inject-failure", "27", "--ckpt-dir",
                                 str(tmp_path / "b")])
    assert hurt["controller"].restarts == 1
    assert clean["controller"].restarts == 0
    for a, b in zip(tree_leaves(clean["params"]), tree_leaves(hurt["params"])):
        assert torch.equal(a, b)
    assert hurt["losses"][-1] < hurt["losses"][0]
    assert len(hurt["losses"]) == 30 + 2       # steps 26-27 ran twice
    assert hurt["pipeline"].windows >= clean["pipeline"].windows
