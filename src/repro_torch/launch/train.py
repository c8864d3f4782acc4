"""Training step factory (port of ``repro.launch.train``): gradient
accumulation over microbatches, AdamW or 8-bit AdamW, optional int8
error-feedback gradient compression.

The batch carries a leading ``accum`` axis (``TokenBatcher``'s
``(accum, mb, S)`` numpy leaves, moved to the model's device); the
microbatch size is chosen by :func:`choose_accum` so that the
rematerialised activations stay under a budget.  The reference's
``lax.scan`` over the microbatches is a Python loop here: each
microbatch's :func:`~repro_torch.models.api.value_and_grad` adds into an
accumulator in ``accum_dtype``, which is then divided by ``accum``.

The step DONATES its arguments: the new parameters and optimizer state
are written into the tensors passed in and returned (a jitted step's
donated buffers; a full-size model's second copy of its f32 moments does
not fit beside the first on one card).  A caller that needs the old state
clones it first.  The values are those of the reference's functional step.

Under ``mesh=`` every microbatch's loss runs under that mesh (the MoE
layers' expert-parallel branches, the sharding hints); the accumulator is
placed as the parameters are (``launch.sharding.param_shardings``: the
dry run's gradient reduce-scatters), on the single-process mesh a
placement statement.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.api import Model, value_and_grad
from ..models.common import tree_map
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw8bit import adamw8bit_update
from ..optim.compress import compress_gradients, decompress_gradients

ACT_BUDGET_BYTES = 2.0e9      # saved-activation budget per device


def choose_accum(cfg: ModelConfig, seq_len: int, global_batch: int,
                 dp: int, model_size: int = 16) -> int:
    """Smallest power-of-two accum count keeping the remat-saved
    activations (the L stacked layer inputs of a microbatch, times a
    family factor for per-layer backward residuals, times ``model_size``
    where the heads cannot shard over the model axis) under
    :data:`ACT_BUDGET_BYTES`."""
    per_dp = max(1, global_batch // dp)
    accum = 1
    L = cfg.n_layers if cfg.family != "encdec" else (
        cfg.encdec.n_encoder_layers + cfg.encdec.n_decoder_layers)
    family_factor = {"ssm": 8.0, "hybrid": 8.0, "encdec": 6.0}.get(
        cfg.family, 1.0)
    if cfg.xlstm is not None:
        family_factor = 8.0
    rep = 1.0 if cfg.n_heads % model_size == 0 else float(model_size)
    while accum < per_dp:
        mb_local = per_dp // accum
        saved = L * mb_local * seq_len * cfg.d_model * 2 * family_factor * rep
        if saved <= ACT_BUDGET_BYTES:
            break
        accum *= 2
    return accum


def to_device(batch: dict, device) -> dict:
    """A batch's leaves (numpy arrays or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def accumulate_gradients(model: Model, params: dict, batch: dict,
                         accum_dtype=torch.float32, mesh=None):
    """The gradient half of the train step: ``(loss, g)``, the mean loss
    over the batch's leading ``accum`` axis and the mean gradient, summed
    microbatch by microbatch in ``accum_dtype`` and divided by ``accum``;
    each microbatch under ``mesh``."""
    batch = to_device(batch, model.device)
    accum = next(iter(batch.values())).shape[0]
    g = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                       device=p.device), params)
    lsum = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(accum):
        loss, grads = value_and_grad(
            model, params, {k: v[i] for k, v in batch.items()}, mesh=mesh)
        tree_map(lambda a, b: a.add_(b.to(accum_dtype)), g, grads)
        lsum = lsum + loss
        del grads
    n = torch.full((), accum, dtype=accum_dtype, device=model.device)
    tree_map(lambda a: a.div_(n), g)
    return lsum / n.to(torch.float32), g


def apply_gradients(opt_cfg: AdamWConfig, g: dict, params: dict,
                    opt_state: dict, compress: bool = False,
                    opt_8bit: bool = False):
    """The update half of the train step, from the mean gradient ``g``
    (consumed: compression rewrites it in place): ``(params, opt_state,
    stats)``, the arguments donated."""
    if compress:
        q, _ = compress_gradients(g, opt_state["ef"])
        decompress_gradients(q, g)
        del q
    ostate = {k: v for k, v in opt_state.items() if k != "ef"}
    if opt_8bit:
        new_p, new_o, stats = adamw8bit_update(opt_cfg, g, ostate, params)
    else:
        new_p, new_o, stats = adamw_update(opt_cfg, g, ostate, params,
                                           inplace=True)
    if compress:
        new_o["ef"] = opt_state["ef"]
    return new_p, new_o, stats


def make_train_step(model: Model, opt_cfg: AdamWConfig, mesh=None,
                    compress: bool = False, accum_dtype=torch.float32,
                    opt_8bit: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    stats)``; ``stats`` holds the mean ``loss``, ``grad_norm`` and ``lr``
    as 0-d tensors on the model's device (no host sync).

    ``opt_state`` is ``adamw_init(params)`` or, with ``opt_8bit``,
    ``adamw8bit_init(params)``; with ``compress`` it also carries the error
    feedback under ``"ef"`` (``ef_init(params)``)."""
    def train_step(params, opt_state, batch):
        loss, g = accumulate_gradients(model, params, batch, accum_dtype,
                                       mesh)
        new_p, new_o, stats = apply_gradients(opt_cfg, g, params, opt_state,
                                              compress, opt_8bit)
        stats["loss"] = loss
        return new_p, new_o, stats

    return train_step


def make_eval_step(model: Model, mesh=None):
    """``eval_step(params, batch) -> loss`` (no gradient), under ``mesh``."""
    def eval_step(params, batch):
        return model.loss(params, to_device(batch, model.device), mesh=mesh)

    return eval_step
