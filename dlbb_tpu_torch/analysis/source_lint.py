"""The AST source lint (counterpart of ``dlbb_tpu/analysis/source_lint.py``,
its rule names, suppression syntax and findings, in the port's idiom).

Rules over the port's files (``DEFAULT_LINT_DIRS``) for the failure modes
a distributed benchmark cares about and generic linters do not:

- ``host-sync-in-timed-region``: ``.item()`` / ``.cpu()`` / ``.numpy()`` /
  ``.tolist()`` / ``torch.cuda.synchronize()`` / ``float()`` or ``int()``
  of a call / ``np.asarray`` / ``np.array`` inside a timed region, except
  through the ``utils/timing.py`` API or as the region's final bracketing
  sync.  A sync mid-region serialises the device into the measurement.
- ``jit-in-loop``: ``torch.compile``, ``torch.jit.script``/``trace`` or
  ``torch.cuda.graph``/``make_graphed_callables`` of a lambda or an
  in-loop ``def`` closing over the loop variable: a fresh callable, and a
  fresh compile or capture, every iteration.  Warning severity.
- ``host-transfer-in-loop``: ``.cpu()`` / ``.numpy()`` / ``.tolist()`` /
  ``torch.cuda.synchronize()`` inside a loop body: a device->host round
  trip every iteration.  Warning severity.  JAX's exemptions: the
  measurement API homes (``TIMING_API_FILES``, ``PROFILER_API_FILES``),
  calls inside a timed region, loops over a constant literal, calls on a
  loop-exit path (an ``if`` body ending in ``break``/``return``/``raise``);
  only the loop body is walked and nested definitions are skipped.
- ``unsorted-set-iteration``: a ``for`` over a set literal or ``set(...)``
  call: hash-order dependent.
- ``wallclock-in-timed-region``: ``time.time()`` / ``datetime.now()`` /
  ``datetime.utcnow()`` / ``date.today()`` inside a timed region, no
  bracketing exemption.
- ``profiler-in-timed-region``: ``torch.profiler.*`` (any ``...profiler...``
  chain) or the port's ``maybe_trace``, ``annotate``, ``step_annotation``,
  ``profile_session`` and ``capture_device_trace`` inside a timed region;
  the API homes (``utils/profiling.py``, ``obs/capture.py``) are exempt.
- ``float64-literal-in-jit``: ``torch.float64`` / ``torch.double``
  (``.to(...)``, ``dtype=``), ``.double()``, and JAX's numpy forms
  (``np.float64(...)``, ``.astype(np.float64 / "float64" / float)``,
  ``dtype=float64``, dtype-free ``np.array`` of float literals and
  ``np.ones``/``zeros``/``linspace``/``full``) inside a timed region or a
  function the same file compiles (``@torch.compile``, passed by name to
  ``torch.compile``/``torch.jit.*``/``make_graphed_callables``) or calls
  inside a ``with torch.cuda.graph(...)`` capture.
- ``non-atomic-artifact-write``: a bare ``json.dump(...)`` or
  ``*.write_text(json.dumps(...))`` outside ``utils/config.py``'s atomic
  helper.

JAX's ``missing-donation`` has no source form in eager torch (there is no
``donate_argnums``): ``LINT_RULES`` is JAX's less that rule, and the
collective audit checks a train step's in-place update at run time
(``op_capture.Capture.has_donation``).

Timed regions are detected syntactically: the body of ``with Timer()``
(``utils/metrics.py``), and the statements strictly between ``<var> =
time.perf_counter()`` and the statement consuming ``time.perf_counter() -
<var>`` in the same block.

Suppression: ``# comm-lint: disable=rule[,rule2]`` trailing on the line
(or on the line directly above), ``# comm-lint: disable-file=rule`` near
the top of the file.
"""

from __future__ import annotations

import ast
import io
import tokenize
from pathlib import Path
from typing import Iterable, Optional

from dlbb_tpu_torch.analysis.findings import (
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    AnalysisReport,
    Finding,
)

LINT_RULES = (
    "host-sync-in-timed-region",
    "wallclock-in-timed-region",
    "profiler-in-timed-region",
    "jit-in-loop",
    "host-transfer-in-loop",
    "unsorted-set-iteration",
    "non-atomic-artifact-write",
    "float64-literal-in-jit",
)

# Files whose whole purpose is host synchronisation around measurement.
TIMING_API_FILES = ("utils/timing.py",)
# The profiler/capture API homes: the only files allowed to bracket a
# profiler session with a wall timer.
PROFILER_API_FILES = ("utils/profiling.py", "obs/capture.py")
# The atomic writer itself.
ATOMIC_API_FILES = ("utils/config.py",)
# Calls through the timing API are never host-sync findings.
TIMING_API_NAMES = {"time_fn_per_iter", "time_fn_per_iter_spmd", "time_collective"}
# tensor methods that copy to the host (and so wait for the device)
_SYNC_METHODS = {"item", "cpu", "numpy", "tolist"}
_SYNC_WRAPPERS = {"float", "int"}
_NP_SYNC_ATTRS = {"asarray", "array"}
_WALLCLOCK_NAMES = {
    "time.time", "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "date.today", "datetime.date.today",
}
# profiler entry points: the port's wrappers by short name, plus anything
# reached through a `...profiler...` attribute chain (torch.profiler.*)
_PROFILER_CALL_NAMES = {
    "maybe_trace", "annotate", "step_annotation", "profile_session",
    "capture_device_trace",
}
# per-iteration device->host transfers the in-loop rule flags
_HOST_TRANSFER_METHODS = {"cpu", "numpy", "tolist"}
# compile / capture entry points (jit-in-loop, float64-literal-in-jit)
_COMPILE_NAMES = (
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.graph", "torch.cuda.make_graphed_callables",
)


def _is_profiler_call(name: str) -> bool:
    short = name.rsplit(".", 1)[-1]
    return short in _PROFILER_CALL_NAMES or "profiler" in name


def _is_cuda_sync(name: str) -> bool:
    return name.endswith("cuda.synchronize")


# ---------------------------------------------------------------------------
# suppression comments
# ---------------------------------------------------------------------------


class Suppressions:
    def __init__(self, source: str):
        self.line_rules: dict[int, set[str]] = {}
        self.file_rules: set[str] = set()
        self.hits = 0
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                text = tok.string.lstrip("# ").strip()
                if not text.startswith("comm-lint:"):
                    continue
                directive = text[len("comm-lint:"):].strip()
                # each rule is its entry's first word: the reason may follow
                # the list on the same line
                if directive.startswith("disable-file="):
                    rules = directive[len("disable-file="):]
                    self.file_rules |= {r.split()[0] for r in rules.split(",")
                                        if r.strip()}
                elif directive.startswith("disable="):
                    rules = directive[len("disable="):]
                    self.line_rules.setdefault(tok.start[0], set()).update(
                        r.split()[0] for r in rules.split(",") if r.strip()
                    )
        except tokenize.TokenError:
            pass

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_rules:
            self.hits += 1
            return True
        for ln in (line, line - 1):
            if rule in self.line_rules.get(ln, set()):
                self.hits += 1
                return True
        return False


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _call_name(node: ast.Call) -> str:
    """Dotted name of a call's function, e.g. "torch.compile" or "Timer"."""
    parts = []
    f = node.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def _is_perf_counter_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _call_name(node).endswith("perf_counter"))


def _free_names(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _is_method_call(node: ast.Call, names: set[str]) -> bool:
    """``<expr>.m()`` for ``m`` in ``names`` (a method call, not a bare
    function of that name)."""
    return isinstance(node.func, ast.Attribute) and node.func.attr in names


def _sync_calls(stmt: ast.stmt) -> Iterable[tuple[ast.Call, str]]:
    """(call, description) for every host-sync call inside ``stmt``."""
    for node in ast.walk(stmt):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        short = name.rsplit(".", 1)[-1]
        if short in TIMING_API_NAMES:
            continue  # the timing API
        if _is_cuda_sync(name):
            yield node, f"{name}()"
        elif name in _SYNC_WRAPPERS and node.args and isinstance(
                node.args[0], ast.Call):
            # float(t.sum()) / int(...) of a computed value forces it to
            # the host
            yield node, f"{name}() on a device value"
        elif short in _NP_SYNC_ATTRS and name.split(".")[0] in ("np",
                                                               "numpy"):
            yield node, name
        elif _is_method_call(node, _SYNC_METHODS):
            yield node, f".{node.func.attr}()"


def _wallclock_calls(stmt: ast.stmt) -> Iterable[tuple[ast.Call, str]]:
    """(call, description) for every wall-clock read inside ``stmt``."""
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call) and _call_name(
                node) in _WALLCLOCK_NAMES:
            yield node, f"{_call_name(node)}()"


def _profiler_calls(stmt: ast.stmt) -> Iterable[tuple[ast.Call, str]]:
    """(call, description) for every profiler/tracing call inside
    ``stmt``."""
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call) and _is_profiler_call(
                _call_name(node)):
            yield node, f"{_call_name(node)}()"


def _walk_skip_defs(node: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` that does not descend into nested function/lambda
    definitions: code defined inside a loop body is not necessarily
    executed per iteration."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _host_transfer_calls(node: ast.AST) -> Iterable[tuple[ast.Call, str]]:
    """(call, description) for every device->host transfer or device sync
    inside ``node`` (nested defs excluded)."""
    for n in _walk_skip_defs(node):
        if not isinstance(n, ast.Call):
            continue
        name = _call_name(n)
        if _is_cuda_sync(name):
            yield n, name
        elif _is_method_call(n, _HOST_TRANSFER_METHODS):
            yield n, f".{n.func.attr}"


def _perf_counter_spans(tree: ast.AST) -> Iterable[tuple[list, int, int, str]]:
    """(block, start index, closing index, variable) of every
    ``t = perf_counter()`` ... ``perf_counter() - t`` span."""
    for scope in ast.walk(tree):
        body = getattr(scope, "body", None)
        if not isinstance(body, list):
            continue
        for blk in (body, getattr(scope, "orelse", None),
                    getattr(scope, "finalbody", None)):
            if not isinstance(blk, list):
                continue
            svars: dict[str, int] = {}
            for idx, stmt in enumerate(blk):
                if (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and _is_perf_counter_call(stmt.value)):
                    svars[stmt.targets[0].id] = idx
                    continue
                closed = set()
                for node in ast.walk(stmt):
                    if (isinstance(node, ast.BinOp)
                            and isinstance(node.op, ast.Sub)
                            and _is_perf_counter_call(node.left)
                            and isinstance(node.right, ast.Name)
                            and node.right.id in svars):
                        closed.add(node.right.id)
                for var in sorted(closed):
                    yield blk, svars.pop(var), idx, var


def _timed_line_spans(tree: ast.AST) -> list[tuple[int, int]]:
    """Line spans of every syntactic timed region (Timer with-blocks and
    perf_counter spans), for the rules that defer to the timed-region
    rules."""
    spans: list[tuple[int, int]] = []
    for node in _timed_with_blocks(tree):
        spans.append((node.lineno, node.end_lineno or node.lineno))
    for blk, start, idx, _ in _perf_counter_spans(tree):
        stmt = blk[idx]
        spans.append((blk[start].lineno, stmt.end_lineno or stmt.lineno))
    return spans


# ---------------------------------------------------------------------------
# rule implementations
# ---------------------------------------------------------------------------


def _timed_with_blocks(tree: ast.AST) -> Iterable[ast.With]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call) and _call_name(ctx).rsplit(
                    ".", 1)[-1] == "Timer":
                yield node
                break


def _check_timed_with(node: ast.With, path: str, findings: list[Finding],
                      check_profiler: bool = True):
    last = node.body[-1]
    region = f"with Timer() at line {node.lineno}"
    for stmt in node.body:
        for call, desc in _sync_calls(stmt):
            if stmt is last:
                continue  # the bracketing sync closing the measurement
            findings.append(Finding(
                pass_name="lint",
                rule="host-sync-in-timed-region",
                severity=SEVERITY_ERROR,
                target=path,
                message=(
                    f"{desc} inside a Timer block (before its final "
                    "statement) serialises device work into the "
                    "measurement; use the utils/timing.py API or move the "
                    "sync to the region boundary"
                ),
                location=f"{path}:{call.lineno}",
                details={"sync": desc, "region": region},
            ))
        for call, desc in _wallclock_calls(stmt):
            findings.append(Finding(
                pass_name="lint",
                rule="wallclock-in-timed-region",
                severity=SEVERITY_ERROR,
                target=path,
                message=(
                    f"{desc} inside a Timer block reads the wall clock, "
                    "which NTP can step mid-measurement; use "
                    "time.perf_counter(), and take wall-clock timestamps "
                    "outside the timed region"
                ),
                location=f"{path}:{call.lineno}",
                details={"clock": desc, "region": region},
            ))
        if not check_profiler:
            continue
        for call, desc in _profiler_calls(stmt):
            findings.append(Finding(
                pass_name="lint",
                rule="profiler-in-timed-region",
                severity=SEVERITY_ERROR,
                target=path,
                message=(
                    f"{desc} inside a Timer block runs a profiler session "
                    "in the measured region; trace on dedicated profile "
                    "reps outside it (dlbb_tpu_torch.obs.capture)"
                ),
                location=f"{path}:{call.lineno}",
                details={"call": desc, "region": region},
            ))


def _check_perf_counter_regions(tree: ast.AST, path: str,
                                findings: list[Finding],
                                check_profiler: bool = True):
    """Statements strictly between ``t = time.perf_counter()`` and the
    statement consuming ``perf_counter() - t`` are a timed region; the
    statement right before the delta is its bracketing sync."""
    for blk, start, idx, var in _perf_counter_spans(tree):
        region = f"perf_counter span '{var}'"
        for mid in blk[start + 1: idx - 1]:
            for call, desc in _sync_calls(mid):
                findings.append(Finding(
                    pass_name="lint",
                    rule="host-sync-in-timed-region",
                    severity=SEVERITY_ERROR,
                    target=path,
                    message=(
                        f"{desc} between {var} = time.perf_counter() and "
                        "its delta serialises device work into the "
                        "measurement; use the utils/timing.py API"
                    ),
                    location=f"{path}:{call.lineno}",
                    details={"sync": desc, "region": region},
                ))
        for mid in blk[start + 1: idx]:
            for call, desc in _wallclock_calls(mid):
                findings.append(Finding(
                    pass_name="lint",
                    rule="wallclock-in-timed-region",
                    severity=SEVERITY_ERROR,
                    target=path,
                    message=(
                        f"{desc} between {var} = time.perf_counter() and "
                        "its delta reads the non-monotonic wall clock; use "
                        "time.perf_counter() and timestamp outside the "
                        "region"
                    ),
                    location=f"{path}:{call.lineno}",
                    details={"clock": desc, "region": region},
                ))
            if not check_profiler:
                continue
            for call, desc in _profiler_calls(mid):
                findings.append(Finding(
                    pass_name="lint",
                    rule="profiler-in-timed-region",
                    severity=SEVERITY_ERROR,
                    target=path,
                    message=(
                        f"{desc} between {var} = time.perf_counter() and "
                        "its delta runs a profiler session inside the "
                        "measured region; move the capture to a dedicated "
                        "profile rep (dlbb_tpu_torch.obs.capture)"
                    ),
                    location=f"{path}:{call.lineno}",
                    details={"call": desc, "region": region},
                ))


def _is_compile_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _call_name(node) in _COMPILE_NAMES


def _check_jit_in_loop(tree: ast.AST, path: str, findings: list[Finding]):
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        loop_vars: set[str] = set()
        if isinstance(loop, ast.For):
            loop_vars = {n.id for n in ast.walk(loop.target)
                         if isinstance(n, ast.Name)}
        in_loop_defs = {
            d.name: d for d in ast.walk(loop)
            if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for node in ast.walk(loop):
            if not _is_compile_call(node) or not node.args:
                continue
            fn = node.args[0]
            if isinstance(fn, ast.Lambda):
                traced, what = fn.body, "lambda ..."
            elif isinstance(fn, ast.Name) and fn.id in in_loop_defs:
                # a def in the loop body is a fresh function every trip
                traced, what = in_loop_defs[fn.id], fn.id
            else:
                continue
            if not loop_vars or _free_names(traced) & loop_vars:
                findings.append(Finding(
                    pass_name="lint",
                    rule="jit-in-loop",
                    severity=SEVERITY_WARNING,
                    target=path,
                    message=(
                        f"{_call_name(node)}({what}) inside a loop makes a "
                        "fresh callable, and a fresh compile or graph "
                        "capture, every iteration; hoist it and pass the "
                        "varying value as an argument"
                    ),
                    location=f"{path}:{node.lineno}",
                    details={"loop_line": loop.lineno},
                ))


def _is_constant_iterable(node: ast.AST) -> bool:
    """A literal tuple/list of constants: a bounded probe ladder, not a
    data loop."""
    return (isinstance(node, (ast.Tuple, ast.List))
            and all(isinstance(e, ast.Constant) for e in node.elts))


def _check_host_transfer_in_loop(tree: ast.AST, path: str,
                                 findings: list[Finding]):
    """``host-transfer-in-loop`` (module docstring)."""
    exempt = _timed_line_spans(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and _is_constant_iterable(node.iter):
            exempt.append((node.lineno, node.end_lineno or node.lineno))
        elif (isinstance(node, ast.If) and node.body
                and isinstance(node.body[-1],
                               (ast.Break, ast.Return, ast.Raise))):
            last = node.body[-1]
            exempt.append((node.body[0].lineno,
                           last.end_lineno or last.lineno))
    seen: set[tuple[int, int]] = set()
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        if isinstance(loop, ast.For) and _is_constant_iterable(loop.iter):
            continue
        for stmt in loop.body:
            for call, desc in _host_transfer_calls(stmt):
                key = (call.lineno, call.col_offset)
                if key in seen:
                    continue  # nested loops find the same call again
                if any(lo <= call.lineno <= hi for lo, hi in exempt):
                    continue
                seen.add(key)
                findings.append(Finding(
                    pass_name="lint",
                    rule="host-transfer-in-loop",
                    severity=SEVERITY_WARNING,
                    target=path,
                    message=(
                        f"{desc}() inside a loop body forces a "
                        "device->host round trip (or a full device sync) "
                        "every iteration; batch the transfer outside the "
                        "loop or keep the reduction on the device"
                    ),
                    location=f"{path}:{call.lineno}",
                    details={"call": desc, "loop_line": loop.lineno},
                ))


def _check_atomic_writes(tree: ast.AST, path: str, findings: list[Finding]):
    """``non-atomic-artifact-write``: JSON artifacts go through the atomic
    helper (tmp + fsync + ``os.replace``)."""

    def is_dumps(e: ast.AST) -> bool:
        if isinstance(e, ast.Call) and _call_name(e).rsplit(
                ".", 1)[-1] == "dumps" and _call_name(e).startswith("json"):
            return True
        if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Add):
            return is_dumps(e.left) or is_dumps(e.right)
        return False

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name == "json.dump":
            findings.append(Finding(
                pass_name="lint",
                rule="non-atomic-artifact-write",
                severity=SEVERITY_ERROR,
                target=path,
                message=(
                    "bare json.dump writes the destination in place: a "
                    "process killed mid-dump leaves a truncated artifact; "
                    "use dlbb_tpu_torch.utils.config.save_json (tmp + "
                    "fsync + os.replace)"
                ),
                location=f"{path}:{node.lineno}",
                details={"call": "json.dump"},
            ))
        elif (name.rsplit(".", 1)[-1] == "write_text" and node.args
                and is_dumps(node.args[0])):
            findings.append(Finding(
                pass_name="lint",
                rule="non-atomic-artifact-write",
                severity=SEVERITY_ERROR,
                target=path,
                message=(
                    "write_text(json.dumps(...)) truncates the destination "
                    "before writing; use dlbb_tpu_torch.utils.config."
                    "save_json / atomic_write_text"
                ),
                location=f"{path}:{node.lineno}",
                details={"call": "write_text(json.dumps)"},
            ))


def _dotted(node: ast.AST) -> str:
    """Dotted name of an Attribute/Name expression ("" when neither)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_compile_decorator(dec: ast.AST) -> bool:
    """``@torch.compile`` / ``@torch.compile(...)`` / ``@torch.jit.script``
    and ``@partial(torch.compile, ...)``."""
    if isinstance(dec, ast.Call):
        name = _call_name(dec)
        if name in _COMPILE_NAMES:
            return True
        return (name.rsplit(".", 1)[-1] == "partial" and bool(dec.args)
                and _dotted(dec.args[0]) in _COMPILE_NAMES)
    return _dotted(dec) in _COMPILE_NAMES


def _compiled_spans(tree: ast.AST) -> list[tuple[int, int]]:
    """Line spans of every function the file compiles or captures:
    decorated defs, defs whose name is passed to a compile entry point,
    the bodies of ``with torch.cuda.graph(...)`` captures, and the defs
    called by name inside them."""
    defs: dict[str, ast.AST] = {}
    spans: list[tuple[int, int]] = []
    named: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
            if any(_is_compile_decorator(d) for d in node.decorator_list):
                spans.append((node.lineno, node.end_lineno or node.lineno))
        elif (_is_compile_call(node) and node.args
                and isinstance(node.args[0], ast.Name)):
            named.add(node.args[0].id)
        elif isinstance(node, ast.With) and any(
                _is_compile_call(item.context_expr) for item in node.items):
            spans.append((node.lineno, node.end_lineno or node.lineno))
            for stmt in node.body:
                for call in ast.walk(stmt):
                    if isinstance(call, ast.Call) and isinstance(call.func, ast.Name):
                        named.add(call.func.id)
    for name in sorted(named):
        d = defs.get(name)
        if d is not None:
            spans.append((d.lineno, d.end_lineno or d.lineno))
    return spans


def _f64_dtype_desc(e: ast.AST) -> Optional[str]:
    """Description when ``e`` denotes the float64 dtype: ``torch.float64``,
    ``torch.double``, ``np.float64``, the ``"float64"``/``"double"``
    string, or the Python ``float`` builtin."""
    name = _dotted(e)
    if name and name.rsplit(".", 1)[-1] in ("float64", "double"):
        return name
    if isinstance(e, ast.Constant) and e.value in ("float64", "double"):
        return repr(e.value)
    if isinstance(e, ast.Name) and e.id == "float":
        return "float (the Python builtin is float64)"
    return None


# dtype-free host-numpy constructors whose default dtype is float64
_NP_F64_DEFAULT_CTORS = {"ones", "zeros", "linspace", "full"}


def _float64_sites(tree: ast.AST) -> Iterable[tuple[ast.AST, str]]:
    """(node, description) for every expression that makes a float64
    value (module docstring)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        short = name.rsplit(".", 1)[-1]
        if short in ("float64", "double") and "." in name:
            yield node, f"{name}(...) cast"
            continue
        if short in ("astype", "to", "type") and node.args:
            desc = _f64_dtype_desc(node.args[0])
            if desc:
                yield node, f".{short}({desc})"
                continue
        for kw in node.keywords:
            if kw.arg == "dtype":
                desc = _f64_dtype_desc(kw.value)
                if desc:
                    yield node, f"{name}(dtype={desc})"
                break
        else:
            if name.split(".")[0] not in ("np", "numpy"):
                continue
            if short in _NP_F64_DEFAULT_CTORS:
                yield node, (f"{name}(...) without dtype= "
                             "(host numpy defaults to float64)")
            elif short in ("array", "asarray") and node.args and any(
                    isinstance(c, ast.Constant) and isinstance(c.value, float)
                    for c in ast.walk(node.args[0])):
                yield node, (f"{name}(...) of float literals without "
                             "dtype= (host numpy defaults to float64)")


def _check_float64(tree: ast.AST, path: str, findings: list[Finding],
                   include_timed: bool = True):
    """``float64-literal-in-jit``: float64 made inside a compiled or
    captured function or a timed region: double the bytes of everything
    downstream, and a dtype the card's fast paths do not run."""
    spans = _compiled_spans(tree)
    if include_timed:
        spans += _timed_line_spans(tree)
    if not spans:
        return
    for node, desc in _float64_sites(tree):
        line = node.lineno
        if not any(lo <= line <= hi for lo, hi in spans):
            continue
        findings.append(Finding(
            pass_name="lint",
            rule="float64-literal-in-jit",
            severity=SEVERITY_ERROR,
            target=path,
            message=(
                f"{desc} inside a compiled function or timed region "
                "makes float64, doubling the bytes of what it touches; "
                "pin an explicit 32-bit dtype (torch.float32 / the "
                "model's policy dtype)"
            ),
            location=f"{path}:{line}",
            details={"expression": desc},
        ))


def _check_set_iteration(tree: ast.AST, path: str, findings: list[Finding]):
    def is_set_expr(e: ast.AST) -> bool:
        if isinstance(e, ast.Set):
            return True
        if isinstance(e, ast.Call) and _call_name(e) == "set":
            return True
        if isinstance(e, ast.BinOp) and isinstance(e.op, ast.BitOr):
            return is_set_expr(e.left) or is_set_expr(e.right)
        return False

    for node in ast.walk(tree):
        if isinstance(node, ast.For) and is_set_expr(node.iter):
            findings.append(Finding(
                pass_name="lint",
                rule="unsorted-set-iteration",
                severity=SEVERITY_ERROR,
                target=path,
                message=(
                    "iterating directly over a set is hash-order "
                    "dependent: artifact and publishing order changes run "
                    "to run; wrap the set in sorted(...)"
                ),
                location=f"{path}:{node.iter.lineno}",
                details={},
            ))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_source(source: str, path: str) -> tuple[list[Finding], int]:
    """Lint one file's source text; returns (findings, suppressed count)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(
            pass_name="lint", rule="syntax-error", severity=SEVERITY_ERROR,
            target=path, message=f"file does not parse: {e}",
            location=f"{path}:{e.lineno or 0}",
        )], 0

    findings: list[Finding] = []
    norm = path.replace("\\", "/")
    if not norm.endswith(TIMING_API_FILES):
        check_prof = not norm.endswith(PROFILER_API_FILES)
        for block in _timed_with_blocks(tree):
            _check_timed_with(block, path, findings,
                              check_profiler=check_prof)
        _check_perf_counter_regions(tree, path, findings,
                                    check_profiler=check_prof)
        if check_prof:
            # the measurement and capture homes drive the device in loops
            # on purpose (timing reps, profile reps)
            _check_host_transfer_in_loop(tree, path, findings)
    _check_jit_in_loop(tree, path, findings)
    _check_set_iteration(tree, path, findings)
    # the timing API computes host-side stats inside its own spans by
    # design: its timed regions are exempt (compiled functions are not)
    _check_float64(tree, path, findings,
                   include_timed=not norm.endswith(TIMING_API_FILES))
    if not norm.endswith(ATOMIC_API_FILES):
        _check_atomic_writes(tree, path, findings)

    sup = Suppressions(source)
    kept = []
    for f in findings:
        line = int(f.location.rsplit(":", 1)[1]) if f.location else 0
        if not sup.suppressed(f.rule, line):
            kept.append(f)
    return kept, sup.hits


# the port's files, as globs under the root
DEFAULT_LINT_DIRS = ("dlbb_tpu_torch/**/*.py", "scripts/torch_*.py",
                     "scripts/_torch_*.py", "chip_smoke.py", "bench_torch.py")


def run_source_lint(
    root: Optional[str] = None,
    paths: Optional[Iterable[str]] = None,
    verbose: bool = False,
) -> AnalysisReport:
    """Lint every file of ``DEFAULT_LINT_DIRS`` under ``root`` (or the
    explicit ``paths``)."""
    report = AnalysisReport()
    if paths is None:
        base = Path(root or ".")
        files = sorted({p for pattern in DEFAULT_LINT_DIRS
                        for p in base.glob(pattern) if p.is_file()})
        if not files:
            # a mistyped --root (or a wrong cwd) must not read as clean
            report.findings.append(Finding(
                pass_name="lint", rule="no-files-linted",
                severity=SEVERITY_ERROR, target=str(base),
                message=(
                    f"no Python files matching {', '.join(DEFAULT_LINT_DIRS)} "
                    f"under {base.resolve()}; is --root the repo root?"
                ),
            ))
            return report
    else:
        files = [Path(p) for p in paths]
    for p in files:
        rel = str(p)
        try:
            source = p.read_text()
        except OSError as e:
            report.findings.append(Finding(
                pass_name="lint", rule="io-error",
                severity=SEVERITY_ERROR, target=rel,
                message=f"cannot read: {e}",
            ))
            continue
        findings, suppressed = lint_source(source, rel)
        report.findings.extend(findings)
        report.suppressed += suppressed
        report.files_linted += 1
        if verbose and findings:
            print(f"[lint] {rel}: {len(findings)} finding(s)")
    return report
