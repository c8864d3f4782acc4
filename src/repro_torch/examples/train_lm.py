"""End-to-end driver: train an LM with the AKPC-cached data pipeline, the
fault-tolerant loop, checkpointing and straggler accounting.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 120]
        [--inject-failure 60] [--device cpu]

The port of ``examples/train_lm.py``, with its flags and defaults: a
dense ~4.5M-parameter model (width 128, 4 layers, sequence 128, vocab
4,096; ``--width`` / ``--layers`` / ``--steps`` scale it), AdamW at lr
3e-3 with 20 warmup steps, batches of 2 microbatches of 4 rows from a
``PackedDataPipeline`` whose AKPC shard cache runs on the model's device
(CUDA unless ``--device cpu``), a ``TrainController`` that checkpoints
every 25 steps and restarts from the latest checkpoint after
``--inject-failure STEP``, and a backup ``StragglerPolicy``.  Prints the
loss (first tenth -> last tenth), the restarts and the data cache's
telemetry, and asserts that the loss fell.
"""
from __future__ import annotations

import argparse
import tempfile

from ..core.replay import resolve_device
from ..data import PackedDataPipeline, ShardStore, TokenBatcher
from ..distributed import FailureInjector, StragglerPolicy, TrainController
from ..launch.train import make_train_step
from ..models.api import build_model
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--inject-failure", type=int, default=-1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="the model's and the shard cache's device "
                    "(default: cuda)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train as ``main`` does; returns the controller, the pipeline, the
    final parameters and the per-step losses."""
    dev = resolve_device(args.device)
    cfg = ModelConfig(
        name="train-lm", family="dense", n_layers=args.layers,
        d_model=args.width, n_heads=max(2, args.width // 32),
        n_kv_heads=max(2, args.width // 64), d_ff=args.width * 4,
        vocab=args.vocab, tie_embeddings=True)
    model = build_model(cfg, device=dev)
    store = ShardStore(n_shards=128, shard_tokens=args.seq * 16,
                       vocab=args.vocab, n_domains=8)
    pipe = PackedDataPipeline(store, batch_rows=8, seq_len=args.seq,
                              device=dev)
    batcher = TokenBatcher(pipe, accum=2, microbatch=4)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    train_step = make_train_step(model, opt_cfg)

    def init_state():
        p = model.init(0)
        return p, adamw_init(p)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    injector = FailureInjector(
        at_steps=(args.inject_failure,) if args.inject_failure > 0 else ())
    ctl = TrainController(train_step, init_state, batcher, ckpt_dir,
                          ckpt_every=25, injector=injector,
                          straggler=StragglerPolicy(mode="backup"))
    params, _ = ctl.run(total_steps=args.steps)
    return {"cfg": cfg, "controller": ctl, "pipeline": pipe,
            "params": params, "losses": [h["loss"] for h in ctl.history]}


def main(argv=None) -> dict:
    args = parse(argv)
    out = run(args)
    cfg, ctl, pipe, losses = (out[k] for k in ("cfg", "controller",
                                               "pipeline", "losses"))
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")
    k = max(1, len(losses) // 10)
    print(f"loss: first10 {sum(losses[:k]) / k:.3f} -> last10 "
          f"{sum(losses[-k:]) / k:.3f}  (restarts: {ctl.restarts})")
    tl = pipe.telemetry
    print(f"data-cache telemetry: {tl.batches} batches, "
          f"{tl.shards_fetched} shard requests, AKPC cache cost "
          f"{tl.akpc_total:.1f}")
    assert losses[-1] < losses[0], "training must reduce loss"
    print("OK")
    return out


if __name__ == "__main__":
    main()
