"""Step functions: the train step (with gradient accumulation over
microbatches), the prefill step and the decode step.

A port of the step half of ``repro.launch.steps``.  Gradients come from
``torch.autograd.grad`` of ``LM.loss`` with respect to detached views of
the parameters (so the caller's tensors stay leaves), and the optimizer
writes the new weights and moments into the given tensors
(``repro_torch.optim.adamw.update``).  The cell half (``Cell``,
``build_cell``, ``dryrun_cell``: lowering a step against a mesh of fake
devices) belongs to the dry-run tooling, ROADMAP queue 1 item 4.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.models.lm import LM
from repro_torch.optim import adamw

F32 = torch.float32


def value_and_grad(lm: LM, params, batch):
    """``((loss, {"nll", "aux_loss"}), grads)`` of ``lm.loss`` at
    ``params``; the gradients have the parameters' structure and dtypes."""
    flat = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    with torch.enable_grad():
        loss, extras = lm.loss(T.unflatten_like(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
    extras = {k: v.detach() for k, v in extras.items()}
    return (loss.detach(), extras), T.unflatten_like(params, list(grads))


def make_train_step(lm: LM, ocfg: adamw.AdamWConfig,
                    microbatches: int = 1, grad_dtype=F32):
    """A train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  With ``k > 1`` microbatches the batch is split ``(k, B/k,
    ...)`` along its first axis and the microbatches' gradients, cast to
    ``grad_dtype``, are averaged in order (saved activations scale with
    ``B/k``); with one the gradients keep the parameters' dtype, as in the
    reference."""
    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (loss, extras), grads = value_and_grad(lm, params, batch)
        else:
            for name, x in batch.items():
                if x.shape[0] % microbatches:
                    raise ValueError(f"batch {name} of {x.shape[0]} rows "
                                     f"does not split into {microbatches}")
            grads = T.tree_map(
                lambda p: torch.zeros(p.shape, dtype=grad_dtype,
                                      device=p.device), params)
            zero = torch.zeros((), dtype=F32,
                               device=T.leaves(params)[0].device)
            loss, nll, aux = zero, zero, zero
            for i in range(microbatches):
                mb = {name: x.reshape(microbatches, x.shape[0] // microbatches,
                                      *x.shape[1:])[i]
                      for name, x in batch.items()}
                (l_i, ex), g_i = value_and_grad(lm, params, mb)
                grads = T.tree_map(
                    lambda a, g: a + g.to(grad_dtype) / microbatches,
                    grads, g_i)
                loss = loss + l_i / microbatches
                nll = nll + ex["nll"] / microbatches
                aux = aux + ex["aux_loss"] / microbatches
            extras = {"nll": nll, "aux_loss": aux}
        params, opt_state, om = adamw.update(grads, opt_state, params, ocfg)
        metrics = {"loss": loss, "nll": extras["nll"],
                   "aux_loss": extras["aux_loss"], **om}
        return params, opt_state, metrics
    return train_step


def make_prefill_step(lm: LM):
    def prefill_step(params, batch):
        return lm.prefill(params, batch["tokens"], aux=batch.get("aux"))
    return prefill_step


def make_decode_step(lm: LM):
    def decode_step(params, caches, tokens):
        return lm.decode_step(params, caches, tokens)
    return decode_step
