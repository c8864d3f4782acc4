"""Abstract inputs of every (arch x shape) dry-run cell (port of
``repro.launch.specs``).

``build_cell(arch, shape, mesh)`` returns a :class:`Cell`: the step of that
cell and its arguments as meta tensors (shapes and dtypes, no device
memory) beside their shardings on ``mesh``.  PyTorch has no lowering step,
so the reference's ``lower_cell`` has two counterparts:

* :func:`trace_cell` runs the step once on the meta tensors under the
  counters of :mod:`repro_torch.launch.cost_analysis`.  A train cell
  traces one microbatch (its cost times ``accum``) and the update once;
* :func:`instantiate_cell` makes real seeded tensors of the cell's shapes
  on a device, so that the cell runs there.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from ..configs import SHAPES, get_config
from ..models.api import Model, build_model
from ..models.common import dtype_of
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init
from ..optim.adamw8bit import adamw8bit_init
from . import cost_analysis as ca
from . import sharding as shd
from .mesh import dp_size
from .train import accumulate_gradients, apply_gradients, choose_accum, \
    make_train_step

# >=100B-class models accumulate gradients in bf16 (halves the largest
# training buffer)
BF16_ACCUM_ARCHS = {"deepseek_v2_236b"}
# 8-bit AdamW is off in every cell, as in the reference
OPT8_ARCHS: set = set()

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    kind: str                       # train | prefill | decode
    seq_len: int
    mesh: Any
    model: Model                    # the model of ``step_fn``
    step_fn: Callable
    args: tuple                     # meta tensors (real once instantiated)
    shardings: tuple                # NamedSharding trees matching args
    donate: tuple = ()
    static: dict = dataclasses.field(default_factory=dict)
    opt_cfg: AdamWConfig | None = None
    accum_dtype: torch.dtype = torch.float32
    opt_8bit: bool = False


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_batch(cfg: ModelConfig, accum: int, mb: int, S: int,
                 train: bool) -> dict:
    """Token / label (+ frontend stub) tensors of one step."""
    shp = (accum, mb) if train else (mb,)
    batch: dict = {}
    if cfg.family == "encdec":
        batch["frames"] = _empty(shp + (S, cfg.d_model), torch.bfloat16)
        batch["tokens"] = _empty(shp + (S,), torch.int32)
    elif cfg.vlm is not None:
        n_text = S - cfg.vlm.n_patches
        batch["patches"] = _empty(shp + (cfg.vlm.n_patches, cfg.vlm.d_patch),
                                  torch.bfloat16)
        batch["tokens"] = _empty(shp + (n_text,), torch.int32)
    else:
        batch["tokens"] = _empty(shp + (S,), torch.int32)
    if train:
        batch["labels"] = _empty(shp + (batch["tokens"].shape[-1],),
                                 torch.int32)
    return batch


def _step(kind: str, model: Model, mesh, S: int, opt_cfg, accum_dtype,
          opt_8bit: bool):
    if kind == "train":
        return make_train_step(model, opt_cfg, mesh=mesh,
                               accum_dtype=accum_dtype, opt_8bit=opt_8bit)
    if kind == "prefill":
        if model.cfg.family == "encdec":
            return functools.partial(model.prefill, mesh=mesh, cache_len=S)
        return functools.partial(model.prefill, mesh=mesh)
    return functools.partial(model.decode_step, mesh=mesh)


def build_cell(arch: str, shape: str, mesh, *,
               opt_cfg: AdamWConfig | None = None,
               global_batch: int | None = None,
               seq_len: int | None = None) -> Cell:
    """The cell of ``arch`` x ``shape`` on ``mesh`` (``global_batch`` /
    ``seq_len`` cut the shape's batch and sequence)."""
    cfg = get_config(arch)
    sh = SHAPES[shape]
    kind = sh["kind"]
    S = seq_len or sh["seq_len"]
    B = global_batch or sh["global_batch"]
    model = build_model(cfg, device=META)
    params = model.init(0)
    pshard = shd.param_shardings(params, mesh, serving=(kind == "decode"))
    step_kw = dict(opt_cfg=None, accum_dtype=torch.float32, opt_8bit=False)

    if kind == "train":
        step_kw = dict(opt_cfg=opt_cfg or AdamWConfig(),
                       accum_dtype=(torch.bfloat16 if arch in BF16_ACCUM_ARCHS
                                    else torch.float32),
                       opt_8bit=arch in OPT8_ARCHS)
        accum = choose_accum(cfg, S, B, dp_size(mesh))
        mb = max(1, B // accum)
        batch = _token_batch(cfg, accum, mb, S, train=True)
        if step_kw["opt_8bit"]:
            opt = adamw8bit_init(params)
            oshard = shd.opt8_state_shardings(params, mesh)
        else:
            opt = adamw_init(params)
            oshard = shd.opt_state_shardings(params, mesh)
        args = (params, opt, batch)
        shardings = (pshard, oshard, shd.batch_shardings(
            batch, mesh, leading_accum=True))
        donate, static = (0, 1), {"accum": accum, "microbatch": mb}
    elif kind == "prefill":
        batch = _token_batch(cfg, 1, B, S, train=False)
        args = (params, batch)
        shardings = (pshard, shd.batch_shardings(batch, mesh))
        donate, static = (), {}
    else:                          # decode: one new token against S cached
        cache = model.init_cache(B, S, dtype_of(cfg.kv_cache_dtype))
        tokens = _empty((B, 1), torch.int32)
        pos = _empty((), torch.int32)
        args = (params, cache, tokens, pos)
        shardings = (pshard, shd.cache_shardings(cache, mesh),
                     shd.NamedSharding(mesh, shd.batch_spec((B, 1), mesh)),
                     shd.NamedSharding(mesh, shd.P()))
        donate, static = (1,), {}
    step = _step(kind, model, mesh, S, **step_kw)
    return Cell(arch, shape, cfg, kind, S, mesh, model, step, args,
                shardings, donate, static, **step_kw)


def arg_bytes(cell: Cell) -> int:
    """Exact bytes a device holds of the cell's arguments."""
    return sum(shd.shard_bytes(a, s) for a, s in zip(cell.args,
                                                     cell.shardings))


@dataclasses.dataclass
class CellCost:
    """The traced cost of one step of a cell: totals over the mesh."""

    flops: float                # the step's FLOPs
    flops_once: float           # one microbatch's (the step's, off train)
    hbm_bytes: float
    peak_bytes: int             # the temporary peak (one microbatch)
    collectives: ca.CollectiveTally
    out_bytes: int              # a device's share of the outputs
    alias_bytes: int            # of them, written into arguments in place


def trace_cell(cell: Cell) -> CellCost:
    """One step of the cell on its meta tensors, under the counters."""
    mesh, tally = cell.mesh, ca.CollectiveTally()
    if cell.kind == "train":
        params, opt, batch = cell.args
        accum = cell.static["accum"]
        one = {k: v[:1] for k, v in batch.items()}
        (_, g), mb = ca.trace(
            functools.partial(accumulate_gradients, cell.model,
                              accum_dtype=cell.accum_dtype, mesh=mesh),
            params, one)
        (new_p, new_o, _), upd = ca.trace(
            functools.partial(apply_gradients, cell.opt_cfg,
                              opt_8bit=cell.opt_8bit),
            g, params, opt, keep=g)
        del g
        ca.layer_collectives(tally, mb.collectives, times=accum)
        ca.param_collectives(
            tally, params, cell.shardings[0], mesh, uses=2 * accum,
            grad_reductions=accum, stationary_experts=_stationary(mb))
        alias = shd.shard_bytes(new_p, cell.shardings[0]) + shd.shard_bytes(
            new_o, cell.shardings[1])
        stats = 3 * 4                 # loss, grad_norm, lr: f32 scalars
        return CellCost(mb.flops * accum + upd.flops, mb.flops,
                        mb.hbm_bytes * accum + upd.hbm_bytes,
                        max(mb.peak_bytes, upd.peak_bytes), tally,
                        alias + stats, alias)
    (logits, cache), run = ca.trace(cell.step_fn, *cell.args)
    ca.layer_collectives(tally, run.collectives)
    ca.param_collectives(tally, cell.args[0], cell.shardings[0], mesh,
                         uses=1, grad_reductions=0,
                         stationary_experts=_stationary(run))
    out = shd.NamedSharding(mesh, shd.batch_spec(logits.shape, mesh)
                            ).shard_bytes(logits.shape, logits.dtype)
    out += shd.shard_bytes(cache, shd.cache_shardings(cache, mesh))
    return CellCost(run.flops, run.flops, run.hbm_bytes, run.peak_bytes,
                    tally, out, 0)


def _stationary(run: ca.TraceCost) -> bool:
    return any(r.what == "moe_weight_stationary" for r in run.collectives)


def _like(t: torch.Tensor, gen: torch.Generator, vocab: int):
    """A seeded tensor shaped as ``t`` on the generator's device: token ids
    below ``vocab``, int8 codes, or N(0, 1) floats."""
    if t.dtype in (torch.int32, torch.int64):
        return torch.randint(0, vocab, t.shape, generator=gen,
                             device=gen.device, dtype=t.dtype)
    if t.dtype == torch.int8:
        return torch.randint(-127, 128, t.shape, generator=gen,
                             device=gen.device, dtype=torch.int8)
    return torch.randn(t.shape, generator=gen, device=gen.device).to(t.dtype)


def instantiate_cell(cell: Cell, device, seed: int = 0) -> Cell:
    """The cell with real seeded tensors of its shapes on ``device``: the
    parameters as ``model.init(seed)`` draws them, a fresh optimizer
    state, random tokens, an N(0, 1) cache, the decode position at the
    cache's middle."""
    model = build_model(cell.cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(seed)

    def like(tree):
        if isinstance(tree, dict):
            return {k: like(v) for k, v in tree.items()}
        return _like(tree, gen, cell.cfg.vocab)

    if cell.kind == "train":
        opt = (adamw8bit_init if cell.opt_8bit else adamw_init)(params)
        args = (params, opt, like(cell.args[2]))
    elif cell.kind == "prefill":
        args = (params, like(cell.args[1]))
    else:
        args = (params, like(cell.args[1]), like(cell.args[2]),
                torch.tensor(cell.seq_len // 2, dtype=torch.int32,
                             device=model.device))
    step = _step(cell.kind, model, cell.mesh, cell.seq_len, cell.opt_cfg,
                 cell.accum_dtype, cell.opt_8bit)
    return dataclasses.replace(cell, model=model, step_fn=step, args=args)
