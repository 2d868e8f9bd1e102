"""A fine-tune: ``training.make_train_step`` steps back to back.

Set-up converts the seed's checkpoint state the way a user's fine-tune
loads a pretrained model (``models.convert.convert_roformer`` into
``load_jax_params(Roformer(cfg), ...)``), builds Adam over its float32
master weights and one step object in the cell's compute type, and drives
that same object through the first steps on the seed's batches (which builds
and warms every kernel). From those steps it keeps what the check compares:
each step's loss, each leaf's first gradient as Adam got it (its first
moment after one step, over ``1 − β₁``), and each leaf's change after the
first steps.

The window runs further steps, each on a new batch made on the card from
the seed, and ends at the first step boundary at or after ``--seconds``. The
rate metric is the training audio (batch × segment) of all the window's
steps over all its time, the batch making and the optimizer included.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from benchlib import seeded
from benchlib.trace import span
from reference import train


def _batch(ctx, k: int):
    """Step ``k``'s ``(mix (B, 2, T), target (B, 1, 2, T))``, made on the card."""
    t = ctx.cell.traffic
    n = int(round(t["segment_s"] * t["rate"]))
    g = seeded.generator(ctx.seed, f"batch-{k}", ctx.device)
    parts = 0.1 * torch.randn((2, t["batch"], 2, n), generator=g, device=ctx.device)
    return parts.sum(0), parts[0][:, None]


def _dtype(ctx):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[ctx.cell.spec["dtype"]]


def build_program(ctx):
    """The program's model, optimizer and step from the seed's weights."""
    from audio_separator_tpu_torch.models.convert import convert_roformer, load_jax_params
    from audio_separator_tpu_torch.models.roformer import Roformer
    from audio_separator_tpu_torch.separator.roformer_config import build_roformer_config
    from audio_separator_tpu_torch.training import make_train_step

    cfg = ctx.cell.config
    state = ctx.cell.family().seeded_state(cfg, ctx.seed, ctx.device)
    rcfg = build_roformer_config(cfg["yaml"], cfg["model_file"])
    tree = convert_roformer({k: v.cpu().numpy() for k, v in state.items()}, rcfg)
    del state
    model = load_jax_params(Roformer(rcfg), tree).to(ctx.device)
    opt = torch.optim.Adam(model.parameters(), lr=float(ctx.cell.spec["lr"]))
    step = make_train_step(rcfg, model, opt, compute_dtype=_dtype(ctx))
    return model, opt, step


def first_steps(ctx, model, opt, step) -> dict:
    """Drive the step through the traffic's first steps; return the losses,
    the first gradients' and the change's norms by leaf."""
    beta1 = opt.param_groups[0]["betas"][0]
    named = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    losses, grad = [], {}
    for k in range(1, int(ctx.cell.traffic["first_steps"]) + 1):
        losses.append(float(step(*_batch(ctx, k))))
        if k == 1:
            # A leaf the optimizer never updated has no moment: no gradient.
            grad = {n: float((opt.state[p]["exp_avg"] / (1 - beta1)).double().norm())
                    if "exp_avg" in opt.state.get(p, {}) else 0.0 for n, p in named.items()}
    change = {n: float((p.detach() - start[n]).double().norm()) for n, p in named.items()}
    return {"losses": losses, "grad": grad, "change": change}


def setup(ctx) -> None:
    model, opt, step = build_program(ctx)
    ctx.state.update(model=model, opt=opt, step=step)
    ctx.state["program"] = first_steps(ctx, model, opt, step)


def window(ctx, win) -> None:
    step = ctx.state["step"]
    k = int(ctx.cell.traffic["first_steps"])
    steps = 0
    while True:
        k += 1
        ctx.attempted += 1
        with span("step", ctx.trace):
            with span("batch", ctx.trace):
                mix, target = _batch(ctx, k)
            loss = float(step(mix, target))
        if loss != loss:
            ctx.failed += 1
        steps += 1
        if time.perf_counter() - win.t0 >= ctx.seconds:
            break
    win.close()
    t = ctx.cell.traffic
    ctx.metrics[ctx.cell.spec["metric"]] = steps * t["batch"] * t["segment_s"] / win.seconds
    ctx.extras.update(steps=steps, window_s=win.seconds)


def release(ctx) -> None:
    for key in ("model", "opt", "step"):
        ctx.state.pop(key, None)
    gc.collect()


def reference_steps(ctx, products=None) -> dict:
    """The plain reference's first steps, float32 with TF32 off (``products``:
    a context-manager factory to compute the products in, for the control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, fam = ctx.cell.config, ctx.cell.family()
    state = fam.seeded_state(cfg, ctx.seed, ctx.device)
    ref = fam.reference(cfg, ctx.device, state, checkpoint=True).train()
    ref.requires_grad_(True)
    groups = fam.program_groups(cfg, ref.state_dict())
    start = {n: p.detach().clone() for n, p in ref.named_parameters()}
    opt = torch.optim.Adam(ref.parameters(), lr=float(ctx.cell.spec["lr"]))
    losses, grad = [], {}
    for k in range(1, int(ctx.cell.traffic["first_steps"]) + 1):
        mix, target = _batch(ctx, k)
        opt.zero_grad(set_to_none=True)
        with products() if products else contextlib.nullcontext():
            loss = train.roformer_loss(ref(mix)[..., : target.shape[-1]], target)
            loss.backward()
        losses.append(loss.item())
        if k == 1:
            grad = train.leaf_norms({n: p.grad for n, p in ref.named_parameters()}, groups)
        opt.step()
    change = train.leaf_norms({n: p.detach() - start[n] for n, p in ref.named_parameters()},
                              groups)
    return {"losses": losses, "grad": grad, "change": change}


def step_flops(ctx) -> float:
    """The forward and backward operations of one step of the plain
    reference at the cell's batch (``torch.utils.flop_counter``), counted on
    one row of the batch without recomputation and scaled by the batch."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, fam = ctx.cell.config, ctx.cell.family()
    ref = fam.reference(cfg, ctx.device, fam.seeded_state(cfg, ctx.seed, ctx.device)).train()
    ref.requires_grad_(True)
    mix, target = _batch(ctx, 1)
    with FlopCounterMode(display=False) as counter:
        train.roformer_loss(ref(mix[:1])[..., : target.shape[-1]], target[:1]).backward()
    return counter.get_total_flops() * mix.shape[0]


def compare(program: dict, reference: dict) -> dict:
    """The three numbers the check holds to their limits, and the two leaf
    gaps over each leaf's own norm (``*_own``, recorded, not compared)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"]))
    grad_gap, grad_leaf = train.worst_leaf_gap(program["grad"], reference["grad"],
                                               reference["grad"])
    change_gap, change_leaf = train.worst_leaf_gap(program["change"], reference["change"],
                                                   reference["grad"])
    own = {}
    for name in ("grad", "change"):
        own[f"{name}_gap_own"], own[f"{name}_leaf_own"] = train.worst_leaf_gap(
            program[name], reference[name], reference["grad"], floor=False)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf, **own}


def check(ctx) -> None:
    reference = reference_steps(ctx)
    gaps = compare(ctx.state["program"], reference)
    ctx.extras.setdefault("notes", {})["first steps"] = {
        "program losses": ctx.state["program"]["losses"], "reference losses": reference["losses"],
        **gaps}
    limits = ctx.cell.spec["limits"]
    for name in ("loss_gap", "grad_gap", "change_gap"):
        ctx.check(name, gaps[name], limits[name])
    if ctx.trace:
        del reference
        torch.cuda.empty_cache()
        ctx.extras["flops_per_step"] = step_flops(ctx)
