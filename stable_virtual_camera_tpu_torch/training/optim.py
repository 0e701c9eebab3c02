"""The fine-tuning optimizer: AdamW under a warmup-cosine schedule, with
optional gradient accumulation, step for step as optax builds it in
stable_virtual_camera_tpu/apps/train_cli.py:143-151.

  * `warmup_cosine_decay_schedule` is optax's schedule of the same name: a
    linear warmup from `init_value` to `peak_value`, then a cosine decay
    over the remaining `decay_steps - warmup_steps` counts.
  * `AdamW` wraps `torch.optim.AdamW` under `LambdaLR`, which match
    `optax.adamw(schedule, weight_decay)` update for update: p <- p - lr *
    (m_hat / (sqrt(v_hat) + eps) + wd * p), with the first update at
    lr = schedule(0) (optax's count starts at 0). optax sees a zero gradient
    for a parameter the loss does not reach (it still decays it), where a
    torch optimizer would skip a parameter whose `.grad` is None, so `step`
    fills such gradients with zeros first.
  * `MultiSteps` averages the gradients of `every_k` calls (optax's running
    mean) and applies one update of the wrapped optimizer on the k-th; the
    schedule advances once per real update.

Both optimizers take gradients from the parameters' `.grad` and clear them
after each call. Both run on shards as they run on whole tensors (every
update is elementwise): `replicate(params)` builds the same optimizer over
other tensors (a rank's replica, or its shards), and `slice_state` /
`concat_state` cut a whole `state_dict()` into a rank's and join the ranks'
back (the update count, a scalar, stays whole on every rank), so a
checkpoint always holds the whole state.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from stable_virtual_camera_tpu_torch.utils import profiling

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
    exponent: float = 1.0,
) -> Schedule:
    """optax.warmup_cosine_decay_schedule as a function of the update count."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine**exponent + alpha)

    return schedule


class AdamW:
    """optax.adamw(learning_rate, weight_decay=...) with optax's default
    b1 = 0.9, b2 = 0.999, eps = 1e-8 over a fixed list of tensors;
    `learning_rate` is a number or a schedule of the update count."""

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        learning_rate: float | Schedule,
        weight_decay: float = 1e-4,
    ):
        self.params = list(params)
        self.learning_rate, self.weight_decay = learning_rate, weight_decay
        schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        # base lr 1.0, so LambdaLR sets each update's lr to schedule(count)
        self.opt = torch.optim.AdamW(
            self.params, lr=1.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
        )
        self.lr = torch.optim.lr_scheduler.LambdaLR(self.opt, schedule)

    def step(self) -> None:
        """Apply one update from the parameters' gradients, then clear them
        (a `train.optimizer` span)."""
        with profiling.span("train.optimizer"):
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.opt.step()
            self.lr.step()
            self.opt.zero_grad(set_to_none=True)

    def replicate(self, params: Iterable[torch.Tensor]) -> "AdamW":
        """A fresh AdamW with the same schedule and decay over `params`."""
        return AdamW(params, self.learning_rate, self.weight_decay)

    def state_dict(self) -> dict:
        return {"adamw": self.opt.state_dict(), "schedule": self.lr.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["adamw"])
        self.lr.load_state_dict(state["schedule"])


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=every_k): gradient
    accumulation over `every_k` calls of `step`."""

    def __init__(self, inner: AdamW, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.params = inner.params
        self.every_k = every_k
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    def step(self) -> None:
        """Fold the current gradients into the running mean; on every k-th
        call apply the wrapped optimizer to the mean. Clears the gradients."""
        n = self.mini_step
        for p, acc in zip(self.params, self.acc):
            if p.grad is not None:
                acc.add_((p.grad - acc) / (n + 1))
            else:
                acc.sub_(acc / (n + 1))
            p.grad = None
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step == 0:
            for p, acc in zip(self.params, self.acc):
                p.grad = acc.clone()
                acc.zero_()
            self.inner.step()

    def replicate(self, params: Iterable[torch.Tensor]) -> "MultiSteps":
        return MultiSteps(self.inner.replicate(params), self.every_k)

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = state["mini_step"]
        for acc, saved in zip(self.acc, state["acc"]):
            acc.copy_(saved)



def map_param_state(state: dict, fn: Callable) -> dict:
    """A copy of an AdamW or MultiSteps `state_dict()` with `fn(i, t)` in
    place of every tensor that has the shape of parameter i (AdamW's
    moments, MultiSteps' running mean); counts and scalars are kept."""
    if "inner" in state:
        return {**state, "inner": map_param_state(state["inner"], fn),
                "acc": [fn(i, t) for i, t in enumerate(state["acc"])]}
    adamw = state["adamw"]
    per_param = {i: {key: fn(i, t) if isinstance(t, torch.Tensor) and t.dim() else t
                     for key, t in entry.items()}
                 for i, entry in adamw["state"].items()}
    return {**state, "adamw": {**adamw, "state": per_param}}


def slice_state(state: dict, cuts: list, rank: int) -> dict:
    """Rank `rank`'s share of a whole optimizer state: `cuts[i]` is
    parameter i's (dim, shard length) or None (whole on every rank)."""

    def cut(i, t):
        if cuts[i] is None:
            return t.clone()
        d, size = cuts[i]
        return t.narrow(d, rank * size, size).clone(memory_format=torch.contiguous_format)

    return map_param_state(state, cut)


def concat_state(states: list[dict], cuts: list) -> dict:
    """The whole optimizer state from every rank's share, in rank order
    (the inverse of `slice_state`)."""
    flat = [[] for _ in states]
    for r, st in enumerate(states):
        map_param_state(st, lambda i, t, r=r: flat[r].append(t))
    it = iter(range(len(flat[0])))

    def join(i, t):
        n = next(it)
        if cuts[i] is None:
            return t
        return torch.cat([f[n].to(t.device) for f in flat], dim=cuts[i][0])

    return map_param_state(states[0], join)
