"""Serving launcher: a local driver of the reduced configs on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --local
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --local --device cpu

The port of ``repro.launch.serve``.  ``--dry`` (lower and compile the
serve step on the production mesh) waits for the dry-run slice and raises.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--dry", action="store_true",
                    help="lower+compile the serve step on the production mesh")
    ap.add_argument("--local", action="store_true",
                    help="run the reduced config on the local device")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.dry:
        raise NotImplementedError(
            "--dry needs the dry-run machinery (launch/dryrun.py), which the "
            "port does not have yet (ROADMAP, queue 1, item 6: dryrun)")

    import numpy as np

    from ..configs import get_smoke_config
    from ..models.api import build_model
    from ..serving import BatchedServer, Request

    cfg = get_smoke_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    srv = BatchedServer(model, params, batch_size=4, cache_len=128)
    rng = np.random.default_rng(0)
    for rid in range(8):
        srv.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, size=4).tolist(), max_new=8))
    done = srv.run(max_steps=400)
    print(f"{cfg.name}: served {len(done)} requests in {srv.steps} steps "
          f"on {model.device}")
    return done


if __name__ == "__main__":
    main()
