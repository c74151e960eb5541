"""Optimizer and LR schedule from the ``training:`` config (counterpart of
``dlbb_tpu/train/optim.py``).

The JAX package builds optax transformations; the port keeps their shape as
plain functions on tensors over the nested parameter dict, with the state
passed in and returned explicitly: ``GradientTransformation(init, update)``,
``update(grads, state, params) -> (updates, new_state)`` and
``apply_updates(params, updates)``.  Every optimizer (``adam``, ``adamw``,
``sgd``, ``adafactor``) and schedule (``constant``, ``cosine``,
``warmup_cosine``) of the JAX package is here, with optax's defaults, and
``cast_moments`` for ``training.moments_dtype``.  Each state keeps one step
count, where optax's chain keeps one per stage that counts (all equal).

The arithmetic follows optax's rules, not ``torch.optim``'s
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
  the promoted dtype (fp32 under bf16 moments) and rounded to the param's;
- a schedule's value is optax's fp32 arithmetic on the int32 count, done
  here in numpy float32, op by op (``optax/schedules/_schedule.py``); XLA's
  cos and numpy's may differ in the last bit;
- adamw adds ``weight_decay * p`` to Adam's direction before the learning
  rate (``add_decayed_weights``), sgd's momentum is ``trace`` (``g +
  momentum * t``), and adafactor is optax's chain with its defaults:
  ``scale_by_factored_rms`` (decay 0.8, statistics factored over the two
  largest dimensions when both are at least 128, eps 1e-30), the update
  clipped to block RMS 1, the learning rate, the parameter's block RMS (at
  least 1e-3), and the sign.  Its decay ``1 - (count + 1) ** -0.8`` is an
  fp32 scalar that promotes the statistics to fp32 before they are stored
  in the param dtype, as in JAX.
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
MOMENTS_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                  "float32": torch.float32}


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and ``update(grads, state,
    params) -> (updates, new_state)``.  ``elementwise``: each element's
    update reads only that element of the gradient, state and parameter, so
    that a shard of a leaf updates alone (ZeRO, ``train/zero.py``); adafactor
    takes RMS statistics over whole leaves and is not."""

    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    elementwise: bool = True


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count (after ``count``
    updates) and the two moment trees (adam and adamw)."""

    count: int
    mu: Any
    nu: Any


class SgdState(NamedTuple):
    """The step count and optax's ``TraceState`` (the momentum tree; None
    without momentum)."""

    count: int
    trace: Any


class AdafactorState(NamedTuple):
    """optax's ``FactoredState``: per leaf, the row and column statistics of
    a factored leaf (``v_row``, ``v_col``; ``[1]`` otherwise) and the full
    statistics of the others (``v``; ``[1]`` for a factored leaf)."""

    count: int
    v_row: Any
    v_col: Any
    v: Any


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


_F32 = np.float32


def cosine_decay(init_value: float, decay_steps: int) -> Callable[[int], Any]:
    """``optax.cosine_decay_schedule(init_value, decay_steps)`` (alpha 0,
    exponent 1, where ``(1 - alpha) * c ** exponent + alpha`` is ``c``)."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = np.minimum(_F32(count), _F32(decay_steps))
        return _F32(init_value) * (
            _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c / _F32(decay_steps))))

    return schedule


def warmup_cosine_decay(peak_value: float, warmup_steps: int,
                        decay_steps: int) -> Callable[[int], Any]:
    """``optax.warmup_cosine_decay_schedule(0.0, peak_value, warmup_steps,
    decay_steps)``: linear from 0 over ``warmup_steps``
    (``optax.linear_schedule``'s ``(0 - peak) (1 - count / warmup) +
    peak``), then the cosine over the remaining ``decay_steps -
    warmup_steps``."""
    cosine = cosine_decay(peak_value, decay_steps - warmup_steps)

    def schedule(count):
        if count >= warmup_steps:
            return cosine(count - warmup_steps)
        frac = _F32(1) - _F32(count) / _F32(warmup_steps)
        return _F32(0.0 - peak_value) * frac + _F32(peak_value)

    return schedule


def build_schedule(train_cfg: dict[str, Any]) -> Callable[[int], Any]:
    """``count -> learning rate``."""
    lr = learning_rate(train_cfg)
    _, name = resolve_names(train_cfg)
    if name == "constant":
        return lambda count: lr
    if name == "cosine":
        return cosine_decay(lr, int(train_cfg.get("decay_steps", 1000)))
    if name == "warmup_cosine":
        return warmup_cosine_decay(lr, int(train_cfg.get("warmup_steps", 100)),
                                   int(train_cfg.get("decay_steps", 1000)))
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


def _scaled(schedule, count: int, sign: int, u: torch.Tensor) -> torch.Tensor:
    """optax's ``scale_by_learning_rate``: ``sign * schedule(count)``,
    rounded to ``u``'s dtype, times ``u``."""
    return _weak(sign * schedule(count), u) * u


def _adam(schedule, b1: float, b2: float, eps: float,
          weight_decay: Optional[float]) -> GradientTransformation:
    def init(params):
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def update(grads, state: AdamState, params=None):
        count = state.count + 1
        # 1 - b ** count in fp32, as optax computes it from the int32 count
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        mu = tree_map(lambda g, m: _weak(1 - b1, g) * g + _weak(b1, m) * m,
                      grads, state.mu)
        nu = tree_map(lambda g, v: _weak(1 - b2, g) * (g * g) + _weak(b2, v) * v,
                      grads, state.nu)

        def direction(m, v, p):
            m_hat = m / _weak(bc1, m)
            v_hat = v / _weak(bc2, v)
            u = m_hat / (torch.sqrt(v_hat) + _weak(eps, v_hat))
            if weight_decay is not None:
                u = u + _weak(weight_decay, p) * p
            return _scaled(schedule, state.count, -1, u)

        return tree_map(direction, mu, nu, params), AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def adam(schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam(schedule)``: optax's ``scale_by_adam`` (``eps_root = 0``,
    no ``mu_dtype``), then the step ``-schedule(count)`` with the count
    before the increment (optax's ``scale_by_learning_rate``)."""
    return _adam(schedule, b1, b2, eps, None)


def adamw(schedule: Callable[[int], float], weight_decay: float = 1e-4,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """``optax.adamw(schedule, weight_decay=...)``: Adam's direction plus
    ``weight_decay * p`` (``add_decayed_weights``), then the step."""
    return _adam(schedule, b1, b2, eps, weight_decay)


def sgd(schedule: Callable[[int], float],
        momentum: Optional[float] = None) -> GradientTransformation:
    """``optax.sgd(schedule, momentum)``: ``trace`` (``t = g + momentum *
    t``, the update is ``t``) when there is a momentum, then the step."""

    def init(params):
        return SgdState(0, None if momentum is None
                        else tree_map(torch.zeros_like, params))

    def update(grads, state: SgdState, params=None):
        trace = grads if momentum is None else tree_map(
            lambda g, t: g + _weak(momentum, t) * t, grads, state.trace)
        updates = tree_map(lambda u: _scaled(schedule, state.count, -1, u), trace)
        return updates, SgdState(state.count + 1, None if momentum is None else trace)

    return GradientTransformation(init, update)


# optax.adafactor's defaults
ADAFACTOR_DECAY, ADAFACTOR_MIN_DIM, ADAFACTOR_EPS = 0.8, 128, 1e-30
ADAFACTOR_CLIP, ADAFACTOR_MIN_SCALE = 1.0, 1e-3


def _factored_dims(shape) -> Optional[tuple[int, int]]:
    """optax's ``_factored_dims``: the two largest dimensions (second
    largest first) when the second largest is at least 128, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


def adafactor(schedule: Callable[[int], float]) -> GradientTransformation:
    """``optax.adafactor(learning_rate=schedule)`` with its defaults (module
    docstring)."""

    def init(params):
        def stats(p):
            dims = _factored_dims(p.shape)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                return one, one, torch.zeros_like(p)
            d1, d0 = dims
            row = [n for i, n in enumerate(p.shape) if i != d0]
            col = [n for i, n in enumerate(p.shape) if i != d1]
            return (torch.zeros(row, dtype=p.dtype, device=p.device),
                    torch.zeros(col, dtype=p.dtype, device=p.device), one)

        triples = tree_map(stats, params)
        return AdafactorState(0, *(tree_map(lambda t, i=i: t[i], triples)
                                   for i in range(3)))

    def update(grads, state: AdafactorState, params=None):
        t = _F32(state.count + 1)
        decay = _F32(1) - t ** _F32(-ADAFACTOR_DECAY)
        rest = _F32(1) - decay
        dec = torch.tensor(decay)
        lr = schedule(state.count)  # scale_by_learning_rate, flip_sign=False

        def one(g, v_row, v_col, v, p):
            dt = p.dtype
            g2 = g * g + _weak(ADAFACTOR_EPS, g)
            dims = _factored_dims(p.shape)
            new_row, new_col, new_v = (torch.zeros((1,), dtype=dt, device=p.device),) * 3
            if dims is not None:
                d1, d0 = dims
                new_row = (dec * v_row.float() + float(rest) * g2.mean(d0).float()).to(dt)
                new_col = (dec * v_col.float() + float(rest) * g2.mean(d1).float()).to(dt)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (new_row / new_row.mean(reduced_d1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (new_col ** -0.5).unsqueeze(d1)
            else:
                new_v = (dec * v.float() + float(rest) * g2.float()).to(dt)
                u = g * new_v ** -0.5
            u = u / torch.clamp(_rms(u) / _weak(ADAFACTOR_CLIP, u), min=1.0)
            u = _weak(lr, u) * u
            rms_p = _rms(p)
            min_scale = torch.full_like(rms_p, _weak(ADAFACTOR_MIN_SCALE, p))
            return (-1 * (u * torch.where(rms_p <= min_scale, min_scale, rms_p)),
                    new_row, new_col, new_v)

        out = tree_map(one, grads, state.v_row, state.v_col, state.v, params)
        parts = [tree_map(lambda o, i=i: o[i], out) for i in range(4)]
        return parts[0], AdafactorState(state.count + 1, *parts[1:])

    return GradientTransformation(init, update, elementwise=False)


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


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _state_at(state, path, rows):
    """The part of an optimizer state for the leaf at ``path`` (and its
    ``rows``, a slice of dim 0, where not None): the same state type, its
    per-parameter trees cut to that piece, the rest (counts) as they are."""
    if isinstance(state, tuple):  # a NamedTuple state
        return type(state)(*(_state_at(s, path, rows) for s in state))
    if isinstance(state, dict):
        leaf = _at(state, path)
        return leaf if rows is None else leaf[rows]
    return state


def _set_at(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


# the elements of one piece of a ``cast_moments`` update: each of its fp32
# temporaries holds 256 MiB at most, and a piece costs a few dozen launches
PIECE_ELEMENTS = 1 << 26


def _pieces(g: torch.Tensor, elementwise: bool) -> list:
    """Slices of ``g``'s dim 0 of at most ``PIECE_ELEMENTS`` each (whole
    rows), or ``[None]``, the whole leaf, where it is small enough or the
    update is not elementwise."""
    if not elementwise or g.dim() == 0 or g.numel() <= PIECE_ELEMENTS:
        return [None]
    n = g.shape[0]
    rows = max(1, PIECE_ELEMENTS // (g.numel() // n))
    return [slice(i, min(i + rows, n)) for i in range(0, n, rows)]


def cast_moments(inner: GradientTransformation, dtype) -> GradientTransformation:
    """Store ``inner``'s floating state leaves in ``dtype``; the update runs
    on the state upcast to fp32, a leaf at a time and, for an elementwise
    ``inner``, a piece of a large leaf's dim 0 at a time (``_pieces``), so
    that the fp32 copies of the state and the update's temporaries live for
    one piece only.  Each piece's result is the whole update's, element for
    element."""
    dtype = MOMENTS_DTYPES[dtype] if isinstance(dtype, str) else dtype

    def init(params):
        return _cast_state(inner.init(params), dtype)

    def update(grads, state, params=None):
        updates, trees, count = {}, {}, None
        for path in _paths(grads):
            g = _at(grads, path)
            p = None if params is None else _at(params, path)
            pieces = _pieces(g, inner.elementwise)
            out = None
            for rows in pieces:
                u, new = inner.update(
                    g if rows is None else g[rows],
                    _cast_state(_state_at(state, path, rows), torch.float32),
                    p if rows is None or p is None else p[rows])
                new = _cast_state(new, dtype)
                parts = [(u, None)] + [(t, f) for f, t in enumerate(new)
                                       if isinstance(t, torch.Tensor)]
                if rows is None:
                    out = parts
                    continue
                if out is None:
                    out = [(t.new_empty(g.shape[:1] + t.shape[1:]), f) for t, f in parts]
                for (dst, _), (src, _) in zip(out, parts):
                    dst[rows] = src
            _set_at(updates, path, out[0][0])
            for t, f in out[1:]:
                _set_at(trees.setdefault(f, {}), path, t)
            count = new[0]
        if count is None:  # no leaves
            return inner.update(grads, state, params)
        fields = [count] + [trees.get(f, None if s is None else {})
                            for f, s in enumerate(state) if f > 0]
        return updates, type(state)(*fields)

    return GradientTransformation(init, update, inner.elementwise)


def apply_updates(params, updates):
    """``p + u`` in the promoted dtype, rounded to ``p``'s dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def build_optimizer(train_cfg: dict[str, Any]) -> GradientTransformation:
    """The optimizer that the ``training:`` section describes."""
    name, _ = resolve_names(train_cfg)
    schedule = build_schedule(train_cfg)
    if name == "adam":
        opt = adam(schedule)
    elif name == "adamw":
        opt = adamw(schedule, weight_decay=float(train_cfg.get("weight_decay", 0.01)))
    elif name == "sgd":
        opt = sgd(schedule, momentum=train_cfg.get("momentum", 0.9))
    elif name == "adafactor":
        opt = adafactor(schedule)
    else:
        raise ValueError(f"unknown training.optimizer {name!r}; known: {OPTIMIZERS}")
    mdt = moments_dtype(train_cfg)
    if mdt is not None:
        opt = cast_moments(opt, mdt)
    return opt
