"""Step functions: the train step (gradient, optional compression,
clip, optimizer), the eval step, the train state, and the decomposed
forward and quality steps.

Counterpart of ``repro.runtime.steps``.  The train and eval steps run
each family's ``loss_fn`` through the kernel set of ``backend``
(``"cuda"``: the hand-written kernels and their backward kernels on the
card; ``"reference"``: the plain versions under autograd, the route
check).  Gradients come from ``torch.autograd.grad`` on detached aliases
of the parameters (no ``.grad`` is kept); the optimizer then updates the
parameters in place (``optim``).  Each decomposed-step factory resolves
ONE :class:`~repro_torch.engine.DecomposeEngine` (from an engine or an
``EngineConfig`` that carries a policy) and threads it through every
block.  The returned functions take tensors on the device the caller
chose (the card by default; the CPU tests pass host tensors).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..configs import ArchConfig
from ..engine import DecomposeEngine, EngineConfig
from ..kernels.ops import make_kernels
from ..models import api
from ..models import decomposed as D
from ..optim import clip_by_global_norm, make_optimizer
from ..tree import leaves, tree_map, unflatten_like

Tree = Any

EngineLike = Union[DecomposeEngine, EngineConfig]


def _resolve_policy_engine(engine: EngineLike) -> DecomposeEngine:
    if isinstance(engine, EngineConfig):
        engine = DecomposeEngine(engine)
    if engine.config.policy is None:
        raise ValueError(
            "decomposed forward/quality steps need a DecompositionPolicy: "
            "pass a DecomposeEngine (or EngineConfig) whose policy is set")
    return engine


def make_decomposed_forward_step(cfg: ArchConfig,
                                 engine: EngineLike) -> Callable:
    """forward(params, tokens [B, S]) → logits [B, S, V] with
    policy-selected decomposed execution."""
    engine = _resolve_policy_engine(engine)

    def forward_step(params, tokens):
        return D.forward(params, cfg, tokens, engine)
    return forward_step


def make_decomposed_quality_step(cfg: ArchConfig,
                                 engine: EngineLike) -> Callable:
    """quality(params, tokens) → KL(dense ‖ decomposed) over the vocab."""
    engine = _resolve_policy_engine(engine)

    def quality_step(params, tokens):
        return D.logit_kl(params, cfg, tokens, engine)
    return quality_step


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def value_and_grad(loss_of: Callable, params: Tree, batch
                   ) -> Tuple[torch.Tensor, Tree]:
    """(loss, gradient tree) of ``loss_of(params, batch)``: the loss is
    taken on detached aliases of the parameters that require a gradient,
    so the caller's tensors keep no ``.grad``; a parameter the loss does
    not reach gets a zero gradient."""
    flat = leaves(params)
    req = [p.detach().requires_grad_(p.is_floating_point()) for p in flat]
    loss = loss_of(unflatten_like(params, req), batch)
    wrt = [r for r in req if r.requires_grad]
    grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    out = []
    for r in req:
        g = next(grads) if r.requires_grad else None
        out.append(torch.zeros_like(r) if g is None else g)
    return loss.detach(), unflatten_like(params, out)


def make_train_step(cfg: ArchConfig, optimizer=None,
                    max_grad_norm: float = 1.0, microbatches: int = 1,
                    grad_transform: Optional[Callable] = None,
                    backend: str = "cuda") -> Callable:
    """train_step(params, opt_state, batch) → (params, opt_state,
    {"loss", "grad_norm"}), the reference's step: the gradient of the
    family's ``loss_fn``, ``grad_transform`` (e.g. PowerSGD), the global
    clip, the optimizer.  ``microbatches`` > 1 splits the batch on its
    first axis and accumulates float32 gradients in a loop (the
    reference scans); the loss and gradients are then the microbatch
    means.  The parameters are updated in place and returned."""
    fns = api.model_fns(cfg)
    opt = optimizer or make_optimizer(cfg)
    kernels = make_kernels(backend)

    def loss_of(params, batch):
        return fns.loss_fn(params, cfg, batch, kernels)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_of, params, batch)
        else:
            loss = torch.zeros((), device=leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l_i, g_i = value_and_grad(loss_of, params, mb)
                tree_map(lambda a, b: a.add_(b.float()), grads, g_i)
                loss = loss + l_i
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_eval_step(cfg: ArchConfig, backend: str = "cuda") -> Callable:
    """eval_step(params, batch) → {"loss"}, without a gradient."""
    fns = api.model_fns(cfg)
    kernels = make_kernels(backend)

    def eval_step(params, batch):
        with torch.no_grad():
            return {"loss": fns.loss_fn(params, cfg, batch, kernels)}
    return eval_step


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     optimizer=None, device=None) -> Tuple[Tree, Tree]:
    """(params, optimizer state): the family's random init from
    ``generator`` on ``device``, and the optimizer's zero state."""
    fns = api.model_fns(cfg)
    opt = optimizer or make_optimizer(cfg)
    params = fns.init(cfg, generator, device)
    return params, opt.init(params)


def abstract_train_state(cfg: ArchConfig, optimizer=None
                         ) -> Tuple[Tree, Tree]:
    """(params, optimizer state) on the ``meta`` device: shapes and dtypes
    with no memory behind them (the reference's ``jax.eval_shape``); the
    template a checkpoint restores into."""
    return init_train_state(cfg, torch.Generator(), optimizer,
                            device="meta")
