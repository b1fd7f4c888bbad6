"""Inverse rendering, and its check.

The target is rendered once in set-up; episodes of `steps_per_episode`
Adam steps recover `leaf` from colours drawn from the seed, the loss read
to the host every step.  Set-up runs the first `checked_steps` steps of
the first episode through the window's own step function, on the object
the window then continues; it logs the first step's forward, backward and
optimiser step apart, and keeps the image that step rendered.

The check: the reference renders its own target and follows the checked
steps from the same starting colours.  `loss_gap` is the largest relative
gap of a step's loss; `grad_gap` the relative gap of the norms of the first
gradient (the program's as its optimiser holds it, exp_avg / (1 - beta1)
after one step); `change_gap` the relative gap of the norms of the leaf's
change over those steps; `first_image_gap_share` the share of the first
step's rendered values off from the reference's by more than `GAP`.  A
path that branches apart in the two (the two Moller-Trumbore forms round
apart on an edge) and sees the bright sky in one of them moves the loss
and the gradient of the leaf it bounced off by percents, the same paths
for every seed (the frame's random streams do not depend on it), while it
moves the image's share by a few values in a thousand.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import scenes
from ..check import DTYPES, reference_scene
from ..faults import half, planted
from ..reference import tracer
from . import Outcome, program_camera

GAP = 1e-3  # a rendered value off by more than this counts in the share


def _keeping(orig, into: list):
    """`orig`, the program's frame, keeping a copy of each image it renders."""
    def frame(*a, **k):
        img = orig(*a, **k)
        into.append(img.detach().clone())
        return img
    return frame


def run(run) -> Outcome:
    pt = run.pt
    from tpu_pathtracer_torch import diff
    from tpu_pathtracer_torch.diff import api

    cfg, mix = run.cell.config, run.cell.traffic
    width, height, leaf = mix["width"], mix["height"], mix["leaf"]
    cam = cfg["camera"]
    run.mark("imports")
    data = scenes.program_scene(pt, cfg).compile(device=run.device)
    run.mark("scene")
    params = pt.RenderParams.create(program_camera(pt, cam, run.device), frame=1)
    kw = dict(width=width, height=height, aspect=width / height,
              samples_per_frame=cfg["samples_per_frame"], max_bounces=cfg["max_bounces"],
              intersector=cfg["intersector"])
    target = diff.render_frame_diff(data, params, **kw).detach()
    run.sync()
    run.mark("target")
    loss_p = diff.make_param_loss(diff.make_loss(target, **kw), data, params, [leaf])
    shape = tuple(diff.get_leaf(data, leaf).shape)
    rng = np.random.default_rng([run.seed_key, 2])
    span = run.tracer.span

    def episode():
        start = rng.random(shape).astype(np.float32)
        value = torch.tensor(start, device=run.device).requires_grad_(True)
        return start, value, torch.optim.Adam([value], lr=mix["learning_rate"])

    def settle(phase):
        run.sync()
        run.mark(phase)

    def step(value, opt, mark=lambda phase: None):
        with span("forward"):
            opt.zero_grad(set_to_none=True)
            loss = loss_p({leaf: value})
        mark("first forward")
        with span("backward", timed=True):
            loss.backward()
        mark("first backward")
        with span("step"):
            opt.step()
        mark("first optimiser step")
        with span("readback"):
            return float(loss.detach())

    # set-up: the first steps of the first episode, which the check follows
    start, value, opt = episode()
    losses, first_grad, shown = [], None, []
    for i in range(mix["checked_steps"]):
        if i == 0:
            with planted([(api, "render_frame_diff", lambda orig: _keeping(orig, shown))]):
                losses.append(step(value, opt, settle))
        else:
            losses.append(step(value, opt))
        if i == 0 and "exp_avg" in opt.state.get(value, {}):
            beta1 = opt.param_groups[0]["betas"][0]
            first_grad = (opt.state[value]["exp_avg"] / (1.0 - beta1)).cpu().numpy()
    change = value.detach().cpu().numpy() - start
    first_image = shown[0].reshape(-1, 3).float().cpu().numpy()
    run.sync()
    setup_s = run.mark("later checked steps")

    steps, in_episode = 0, mix["checked_steps"]
    with run.tracer:
        with span("window"):
            t_start = time.perf_counter()
            while True:
                if in_episode == mix["steps_per_episode"]:
                    with span("reset"):
                        _, value, opt = episode()
                        in_episode = 0
                step(value, opt)
                in_episode += 1
                steps += 1
                now = time.perf_counter()
                if now - t_start >= run.seconds:
                    break
    window = now - t_start
    return Outcome(
        end_to_end={"step_ms": 1e3 * window / steps, "setup_s": setup_s},
        counts={"steps": steps},
        answers={"start": start, "losses": losses, "first_grad": first_grad, "change": change,
                 "first_image": first_image,
                 "leaf": leaf, "width": width, "height": height,
                 "learning_rate": mix["learning_rate"], "betas": opt.defaults["betas"],
                 "eps": opt.defaults["eps"]})


def _follow(config: dict, answers: dict, device, dtype):
    """The reference's losses, first gradient, change and first image over
    the checked steps from the program's starting colours, against its own
    target."""
    scene = reference_scene(config, device, dtype)
    width, height = answers["width"], answers["height"]
    ys, xs = torch.meshgrid(torch.arange(height, device=device), torch.arange(width, device=device),
                            indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    seed, o, d = tracer.primary(scene, config["camera"], xs, ys, 1, width, height)
    paths = tracer.trace(scene, o, d, seed, config["max_bounces"])
    target = tracer.radiance(paths, scene.color, scene.specular, scene.emission).detach()
    value = torch.tensor(answers["start"], device=device).to(dtype)
    (b1, b2), eps, lr = answers["betas"], answers["eps"], answers["learning_rate"]
    m = torch.zeros_like(value)
    v = torch.zeros_like(value)
    losses, first, first_image = [], None, None
    start = value.clone()
    for k in range(1, len(answers["losses"]) + 1):
        x = value.detach().requires_grad_(True)
        img = tracer.radiance(paths, x, scene.specular, scene.emission)
        loss = 0.5 * torch.mean((img - target) ** 2)
        (g,) = torch.autograd.grad(loss, [x])
        losses.append(float(loss.detach()))
        if first is None:
            first, first_image = g.detach(), img.detach()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        value = value - lr * (m / (1 - b1 ** k)) / (torch.sqrt(v / (1 - b2 ** k)) + eps)
    return (np.asarray(losses), first.float().cpu().numpy(),
            (value - start).float().cpu().numpy(), first_image.float().cpu().numpy())


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def check(config: dict, mix: dict, answers: dict, seed_key: int, device,
          control: str | None = None) -> dict:
    want_losses, want_grad, want_change, want_image = _follow(config, answers, device,
                                                              torch.float32)
    if control:
        losses, grad, change, image = _follow(config, answers, device, DTYPES[control])
    else:
        losses, grad, change, image = (np.asarray(answers["losses"]), answers["first_grad"],
                                       answers["change"], answers["first_image"])
    norm = np.linalg.norm
    fmt = lambda a: np.array2string(np.asarray(a).reshape(-1), precision=6)
    print(f"inversion: first gradient {fmt(grad)} against {fmt(want_grad)}; change {fmt(change)} "
          f"against {fmt(want_change)}", file=sys.stderr)
    gap = np.abs(image - want_image).reshape(-1)
    print(f"first image gaps: {gap.size} values, over {GAP} {float((gap > GAP).mean())!r}, "
          f"mean {float(gap.mean())!r} max {float(gap.max())!r}", file=sys.stderr)
    return {
        "loss_gap": max(_rel(a, b) for a, b in zip(losses, want_losses)),
        "grad_gap": 1.0 if grad is None else _rel(norm(grad), norm(want_grad)),
        "change_gap": _rel(norm(change), norm(want_change)),
        "first_image_gap_share": float((gap > GAP).mean()),
    }


def fault(name: str) -> list:
    from tpu_pathtracer_torch.diff import api

    if name == "frozen_state":  # the optimiser's step does nothing
        return [(torch.optim.Adam, "step", lambda orig: lambda self, closure=None: None)]
    if name == "half_batch":  # every odd row of each frame copies the row below it
        return [(api, "render_frame_diff", lambda orig: lambda *a, **k: half(orig(*a, **k)))]
    if name == "altered_answer":  # the rendered frame's red scaled by 0.9
        def scaled(orig):
            def frame(*a, **k):
                img = orig(*a, **k)
                return torch.cat([img[..., :1] * 0.9, img[..., 1:]], dim=-1)
            return frame
        return [(api, "render_frame_diff", scaled)]
    raise ValueError(f"unknown fault {name!r}")
