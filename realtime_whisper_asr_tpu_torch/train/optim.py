"""The optimizer pieces the JAX package takes from ``optax``, in torch.

The JAX package trains with ``optax`` (``train/train_step.py``,
``tools/finetune.py``, ``tools/train_vad.py``), a JAX library the port may
not import. This module is the port's copy of the pieces it uses, each with
optax's arithmetic in optax's order, so that the same gradients give the same
parameters:

- ``adam`` / ``adamw``: ``scale_by_adam`` (``mu = (1-b1)·g + b1·mu``,
  ``nu = (1-b2)·g² + b2·nu``, each moment divided by ``1 - b**count``, then
  ``mu_hat / (sqrt(nu_hat) + eps)``), then for ``adamw`` the decayed weights
  ADDED to the update (``u + wd·p``), then the learning rate as a multiply
  by ``-lr``. ``torch.optim.AdamW`` instead decays the parameter before the
  Adam step and defaults to a weight decay of 0.01; ``optax.adamw``'s
  default is 1e-4;
- ``clip_by_global_norm``: ``g / norm * max_norm`` when the norm reaches
  ``max_norm`` (``clip_grad_norm_`` divides by ``norm + 1e-6``);
- ``warmup_cosine_decay_schedule``: evaluated at the count BEFORE the
  update, as optax's ``scale_by_schedule`` does, so a warm-up from 0 makes
  the first step's learning rate 0;
- ``chain``, and ``apply_updates`` (in place, ``p += u``).

A transformation is ``GradientTransformation(init, update)`` over dicts of
tensors (parameter name -> tensor), as optax's over pytrees. Counts are
host ints and every scalar (bias corrections, learning rates) is computed on
the host in float32 as XLA computes it, so a step needs no host sync.
Everything is updated in place, the train step's stand-in for
``donate_argnums``: ``update`` writes the new updates into the tensors of
the ``updates`` it is given (the gradients) and returns that dict, and
updates the moments of the state it is given. A step of a large model then
holds the parameters, the gradients and the two moments, and one leaf's
temporaries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

Params = dict  # name -> tensor
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(updates, state, params) ->
    (updates, state)``."""

    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]


@dataclasses.dataclass
class ScaleByAdamState:
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class ScaleByScheduleState:
    count: int


class EmptyState(NamedTuple):
    pass


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in a tensor op)."""
    return float(np.float32(x))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax's ``tree_bias_correction``:
    the float32 power rounded from float64 (XLA's float32 ``power`` agrees
    with it at every count below 872; numpy's and torch's float32 powers
    do not), then the float32 difference."""
    power = np.float32(np.float64(np.float32(decay)) ** count)
    return _f32(np.float32(1) - power)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, through float64 (XLA's is
    correctly rounded; torch's vectorized float32 one on the CPU is not, at
    ~0.7 % of arguments)."""
    return x.double().sqrt_().float()


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """optax's ``scale_by_adam`` with ``eps_root = 0`` and no Nesterov term."""
    c1, c2, e = _f32(1 - b1), _f32(1 - b2), _f32(eps)
    d1, d2 = _f32(b1), _f32(b2)

    def init(params: Params) -> ScaleByAdamState:
        return ScaleByAdamState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                                {k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates: Params, state: ScaleByAdamState, params=None):
        count = state.count + 1
        with torch.no_grad():
            # the divisors as 0-d tensors on the moments' device: CUDA turns a
            # division by a Python scalar into a multiply by its reciprocal
            dev = next(iter(state.mu.values())).device
            bc1, bc2 = (torch.full((), _bias_correction(b, count), device=dev)
                        for b in (b1, b2))
            for k, g in updates.items():
                mu, nu = state.mu[k], state.nu[k]
                mu.mul_(d1).add_(g * c1)  # (1 - b1)·g + b1·mu
                nu.mul_(d2).add_(g * g * c2)  # (1 - b2)·g² + b2·nu
                g.copy_((mu / bc1) / (_sqrt(nu / bc2) + e))
        return updates, ScaleByAdamState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """``u + wd·p`` for every leaf (optax's default: no mask)."""
    wd = _f32(weight_decay)

    def update(updates: Params, state, params: Params):
        with torch.no_grad():
            for k, u in updates.items():
                u.add_(params[k] * wd)
        return updates, state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]) -> GradientTransformation:
    """``-lr · u``; a schedule is read at the count before this update."""
    if not callable(learning_rate):
        lr = _f32(-1 * learning_rate)

        def update_const(updates: Params, state, params=None):
            with torch.no_grad():
                for u in updates.values():
                    u.mul_(lr)
            return updates, state

        return GradientTransformation(lambda params: EmptyState(), update_const)

    def update(updates: Params, state: ScaleByScheduleState, params=None):
        lr = -_f32(learning_rate(state.count))
        with torch.no_grad():
            for u in updates.values():
                u.mul_(lr)
        return updates, ScaleByScheduleState(state.count + 1)

    return GradientTransformation(lambda params: ScaleByScheduleState(0), update)


class ShardedLeaves(dict):
    """A rank's leaves (name -> tensor) of which those named in ``split``
    are its parts of leaves split over ``group`` (a mesh's model group, a
    pipeline's stages); the rest are whole and equal on every rank. The
    sharded train steps hand their gradients to the optimizer as one, so
    that ``global_norm`` is the norm of the whole tree."""

    def __init__(self, leaves: Params, split: frozenset, group):
        super().__init__(leaves)
        self.split, self.group = split, group


def global_norm(updates: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, as a
    float32 0-d tensor. The squares are float32 (optax's); the sums
    accumulate in float64, so the norm is the rounded exact one whatever
    the device's reduction order (XLA's float32 order is its own).

    ``ShardedLeaves``: a split leaf's sum is its parts' local sums,
    all-reduced over the group as float64 (one all-reduce, whatever the
    group's size); a whole leaf counts once. The leaves are then added in
    the dict's order, as for a whole tree."""
    sums = [torch.sum(u * u, dtype=torch.float64) for u in updates.values()]
    if isinstance(updates, ShardedLeaves):
        import torch.distributed as dist

        at = [i for i, k in enumerate(updates) if k in updates.split]
        if at:
            parts = torch.stack([sums[i] for i in at])
            dist.all_reduce(parts, group=updates.group)
            for j, i in enumerate(at):
                sums[i] = parts[j]
    return torch.sqrt(sum(sums)).float()


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Every leaf ``/ norm * max_norm`` when the global norm is not below
    ``max_norm`` (a select on the card, no host sync)."""
    m = _f32(max_norm)

    def update(updates: Params, state, params=None):
        with torch.no_grad():
            norm = global_norm(updates)
            keep = norm < m
            for u in updates.values():
                u.copy_(torch.where(keep, u, u / norm * m))
        return updates, state

    return GradientTransformation(lambda params: EmptyState(), update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params: Params) -> tuple:
        return tuple(t.init(params) for t in transforms)

    def update(updates: Params, state: tuple, params: Optional[Params] = None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def adam(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def apply_updates(params: Params, updates: Params) -> None:
    """``p += u`` in place, for every leaf."""
    with torch.no_grad():
        for k, u in updates.items():
            params[k].add_(u)


# ---------------------------------------------------------------- schedules


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax's ``linear_schedule`` (``polynomial_schedule``, power 1) in float32."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return _f32(np.float32(init_value - end_value) * frac + np.float32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax's ``cosine_decay_schedule`` (exponent 1) in float32."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = np.minimum(np.float32(count), np.float32(decay_steps))
        # XLA's float32 cosine agrees with the float64 one rounded to float32
        # (at 98.8 % of arguments on [0, 2π]; numpy's float32 one at 83 %)
        x = np.float32(math.pi) * c / np.float32(decay_steps)
        cos = np.float32(np.cos(np.float64(x)))
        decay = np.float32(0.5) * (np.float32(1) + cos)
        decayed = np.float32(1 - alpha) * decay + np.float32(alpha)
        return _f32(np.float32(init_value) * decayed)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """Linear warm-up from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at ``decay_steps``
    (optax's, with its ``join_schedules`` at the boundary)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)
