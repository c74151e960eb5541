"""Optimizer and LR schedule from the ``training:`` config (counterpart of
``dlbb_tpu/train/optim.py``).

The JAX package builds optax transformations; the port keeps their shape as
plain functions on tensors over the nested parameter dict, with the state
passed in and returned explicitly: ``GradientTransformation(init, update)``,
``update(grads, state, params) -> (updates, new_state)`` and
``apply_updates(params, updates)``.  Ported so far: ``adam`` with the
``constant`` schedule, and ``cast_moments`` for ``training.moments_dtype``.
The other names raise ``NotImplementedError``.

The arithmetic follows optax's rules, not ``torch.optim.Adam``'s
(``optax/_src/transform.py::scale_by_adam``, ``update.py::apply_updates``):

- without ``moments_dtype`` mu and nu are held in the params' dtype (bf16 for
  the 1B model), and every step of the update rounds to that dtype;
- with ``cast_moments`` the state is upcast to fp32 around the update and
  stored back in the moments dtype;
- a Python constant meets a tensor the way JAX's weak types do: it is first
  rounded to the tensor's dtype (``(1 - b1) * g`` multiplies g by bf16(0.1)
  when g is bf16);
- nu squares the gradient in the gradient's dtype before any promotion;
- the bias correction ``1 - b**count`` is fp32, from the count after the
  increment, and is rounded to the moment's dtype before the division;
- the learning rate is rounded to the update's dtype; ``p + u`` is formed in
  the promoted dtype (fp32 under bf16 moments) and rounded to the param's.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

OPTIMIZERS = ("adam", "adamw", "sgd", "adafactor")
SCHEDULES = ("constant", "cosine", "warmup_cosine")
DEFAULT_OPTIMIZER = "adam"
DEFAULT_SCHEDULE = "constant"
DEFAULT_LR = 1e-3
PORTED_OPTIMIZERS = ("adam",)
MOMENTS_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                  "float32": torch.float32}

_LATER = ("is not ported to dlbb_tpu_torch yet (a later slice: ROADMAP.md, "
          "Queue 1, Slice D)")


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and ``update(grads, state,
    params) -> (updates, new_state)``."""

    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count (after ``count``
    updates) and the two moment trees."""

    count: int
    mu: Any
    nu: Any


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict (and its twins in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def resolve_names(train_cfg: dict[str, Any]) -> tuple[str, str]:
    """(optimizer, schedule) names as ``build_optimizer`` resolves them."""
    return (train_cfg.get("optimizer", DEFAULT_OPTIMIZER),
            train_cfg.get("schedule", DEFAULT_SCHEDULE))


def learning_rate(train_cfg: dict[str, Any]) -> float:
    """The configured (peak) learning rate."""
    return float(train_cfg.get("learning_rate", DEFAULT_LR))


def build_schedule(train_cfg: dict[str, Any]) -> Callable[[int], float]:
    """``count -> learning rate``."""
    lr = learning_rate(train_cfg)
    _, name = resolve_names(train_cfg)
    if name == "constant":
        return lambda count: lr
    if name in SCHEDULES:
        raise NotImplementedError(f"training.schedule {name!r} {_LATER}")
    raise ValueError(f"unknown training.schedule {name!r}; known: {SCHEDULES}")


def moments_dtype(train_cfg: dict[str, Any]) -> Optional[str]:
    """The configured optimizer-state storage dtype (None = the params')."""
    dt = train_cfg.get("moments_dtype")
    if dt is None:
        return None
    if dt not in MOMENTS_DTYPES:
        raise ValueError(
            f"unknown training.moments_dtype {dt!r} "
            "(expected bfloat16/float16/float32)")
    return dt


def _weak(value: float, like: torch.Tensor) -> float:
    """A Python constant as JAX's weak typing makes it meet ``like``:
    rounded to ``like``'s dtype first."""
    return float(torch.tensor(value, dtype=torch.float64).to(like.dtype))


def adam(schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam(schedule)``: optax's ``scale_by_adam`` (``eps_root = 0``,
    no ``mu_dtype``), then the step ``-schedule(count)`` with the count
    before the increment (optax's ``scale_by_learning_rate``)."""

    def init(params):
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def update(grads, state: AdamState, params=None):
        count = state.count + 1
        # 1 - b ** count in fp32, as optax computes it from the int32 count
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        step = -1 * schedule(state.count)
        mu = tree_map(lambda g, m: _weak(1 - b1, g) * g + _weak(b1, m) * m,
                      grads, state.mu)
        nu = tree_map(lambda g, v: _weak(1 - b2, g) * (g * g) + _weak(b2, v) * v,
                      grads, state.nu)

        def direction(m, v):
            m_hat = m / _weak(bc1, m)
            v_hat = v / _weak(bc2, v)
            u = m_hat / (torch.sqrt(v_hat) + _weak(eps, v_hat))
            return _weak(step, u) * u

        return tree_map(direction, mu, nu), AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def _castable(x) -> bool:
    # wide floats only: counts and byte-wide bookkeeping pass through
    return (isinstance(x, torch.Tensor) and x.dtype.is_floating_point
            and x.element_size() >= 2)


def _cast_state(state, dtype: torch.dtype):
    if isinstance(state, tuple):  # a NamedTuple state
        return type(state)(*(_cast_state(s, dtype) for s in state))
    if isinstance(state, dict):
        return {k: _cast_state(v, dtype) for k, v in state.items()}
    return state.to(dtype) if _castable(state) else state


def cast_moments(inner: GradientTransformation, dtype) -> GradientTransformation:
    """Store ``inner``'s floating state leaves in ``dtype``; the update runs
    on the state upcast to fp32."""
    dtype = MOMENTS_DTYPES[dtype] if isinstance(dtype, str) else dtype

    def init(params):
        return _cast_state(inner.init(params), dtype)

    def update(grads, state, params=None):
        updates, new_state = inner.update(grads, _cast_state(state, torch.float32),
                                          params)
        return updates, _cast_state(new_state, dtype)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """``p + u`` in the promoted dtype, rounded to ``p``'s dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def build_optimizer(train_cfg: dict[str, Any]) -> GradientTransformation:
    """The optimizer that the ``training:`` section describes."""
    name, _ = resolve_names(train_cfg)
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown training.optimizer {name!r}; known: {OPTIMIZERS}")
    if name not in PORTED_OPTIMIZERS:
        raise NotImplementedError(f"training.optimizer {name!r} {_LATER}")
    opt = adam(build_schedule(train_cfg))
    mdt = moments_dtype(train_cfg)
    if mdt is not None:
        opt = cast_moments(opt, mdt)
    return opt
