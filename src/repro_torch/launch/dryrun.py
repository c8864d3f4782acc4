"""The dry run: every (architecture x input shape x mesh) cell sized on the
production meshes without device memory (port of ``repro.launch.dryrun``).

For every cell, the step runs once on meta tensors (``specs.trace_cell``)
on the single-pod (data=16, model=16) AND the 2-pod (pod=2, data=16,
model=16) mesh of logical meta shards.  The record holds the per-device
memory (fits-in-HBM against one H100's 80 GB), the traced FLOPs / HBM
bytes, the modelled collective wire bytes (``cost_analysis``) and the
roofline terms, under the reference's keys, one JSONL line a cell, read by
``python -m repro_torch.bench.run roofline``.  Keys whose meaning differs:
``lower_s`` is the cell's build, ``compile_s`` its trace;
``xla_flops_once`` one microbatch's FLOPs (a train step's loop body
once); ``temp_bytes`` the trace's peak of the storages it creates (the
outputs among them), so ``live_bytes_per_dev`` is arguments plus temp and
``alias_bytes`` (what the step writes into its arguments in place)
frees nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out experiments/dryrun_torch.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from .cost_analysis import HBM_PER_DEVICE, make_roofline

DEFAULT_OUT = "experiments/dryrun_torch.jsonl"


def model_flops_for(cfg, shape_name: str) -> float:
    from ..configs import SHAPES

    sh = SHAPES[shape_name]
    n_act = cfg.param_count(active_only=True) - cfg.vocab * cfg.d_model
    tokens = sh["global_batch"] * (sh["seq_len"] if sh["kind"] != "decode"
                                   else 1)
    mult = 6.0 if sh["kind"] == "train" else 2.0
    return mult * n_act * tokens


def run_cell(arch: str, shape: str, mesh_kind: str) -> dict:
    """The record of one cell on a production mesh of meta shards."""
    from ..configs import get_config, shape_applicable
    from .mesh import make_production_mesh
    from .specs import arg_bytes, build_cell, trace_cell

    cfg = get_config(arch)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    if not shape_applicable(cfg, shape):
        rec.update(status="skipped",
                   reason="long_500k needs sub-quadratic attention "
                          "(DESIGN.md §4)")
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                devices="meta")
    n_dev = mesh.size
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh)
        t_build = time.time() - t0
        cost = trace_cell(cell)
        t_trace = time.time() - t0 - t_build
        args_b = arg_bytes(cell)
        temp = cost.peak_bytes // n_dev
        live = args_b + temp
        rl = make_roofline(cost.flops / n_dev, cost.hbm_bytes / n_dev,
                           sum(cost.collectives.bytes.values()), n_dev,
                           model_flops_for(cfg, shape))
        rec.update(
            status="ok",
            lower_s=round(t_build, 1),
            compile_s=round(t_trace, 1),
            static=cell.static,
            arg_bytes=args_b,
            temp_bytes=temp,
            out_bytes=cost.out_bytes,
            alias_bytes=cost.alias_bytes,
            live_bytes_per_dev=live,
            fits_hbm=bool(live < HBM_PER_DEVICE),
            xla_flops_once=cost.flops_once,
            flops_per_dev=rl.flops_per_dev,
            hbm_bytes_per_dev=rl.hbm_bytes_per_dev,
            coll_bytes_per_dev=rl.coll_bytes_per_dev,
            coll_by_kind={k: round(v)
                          for k, v in cost.collectives.bytes.items()},
            coll_counts={k: int(v)
                         for k, v in cost.collectives.counts.items()},
            compute_s=rl.compute_s,
            memory_s=rl.memory_s,
            collective_s=rl.collective_s,
            dominant=rl.dominant,
            model_flops=rl.model_flops,
            useful_flops_ratio=round(rl.useful_flops_ratio, 4),
            roofline_fraction=round(rl.roofline_fraction, 4),
        )
    except Exception as e:  # noqa: BLE001 — the record IS the result
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   tb=traceback.format_exc()[-2000:],
                   seconds=round(time.time() - t0, 1))
    return rec


def main(argv=None) -> list:
    from ..configs import ARCHS, SHAPES, resolve

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--redo", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [resolve(args.arch)]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out) and not args.redo:
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    recs = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                key = (arch, shape, mesh_kind)
                if key in done:
                    print(f"[skip-done] {key}", flush=True)
                    continue
                print(f"[run] {arch} x {shape} x {mesh_kind}", flush=True)
                rec = run_cell(arch, shape, mesh_kind)
                recs.append(rec)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                msg = rec.get("status")
                if msg == "ok":
                    print(
                        f"  ok: trace {rec['compile_s']}s, "
                        f"live/dev {rec['live_bytes_per_dev'] / 1e9:.2f}GB, "
                        f"fits={rec['fits_hbm']}, dom={rec['dominant']}, "
                        f"frac={rec['roofline_fraction']}", flush=True)
                else:
                    print(f"  {msg}: {rec.get('reason', rec.get('error'))}",
                          flush=True)
    return recs


if __name__ == "__main__":
    main()
