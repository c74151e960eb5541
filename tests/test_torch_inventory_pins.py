"""The causes of the pinned inventory differences
(``tests/test_torch_hlo_audit.py::INVENTORY_EXCEPTIONS``) held against
JAX's HLO.

Each pinned target of JAX's ``default_targets()`` is compiled here (8
simulated CPU devices, as the JAX package's own audit tests run it) and
its schedule pass's collectives are grouped by kind and by the last part
of their op name (XLA's metadata: ``.../closed_call/slice``, ``.../pad``,
``ring_hop_fwd1/ppermute``, none).  The collectives a cause names are
counted, and what is left is held against the port's pinned inventory
(count, kinds and wire bytes by kind).  Where this host's XLA compiles
another program than the one behind JAX's committed baseline (the train
steps: it combines their all-reduces), the test says so and holds the
wire that both agree on.
"""

import json
from collections import Counter

import pytest
from test_torch_hlo_audit import INVENTORY_EXCEPTIONS, JAX_BASELINES, NATIVE_ROOTED

from dlbb_tpu.analysis import hlo_audit as jax_audit
from dlbb_tpu.analysis import schedule_audit as jax_sched

QKV = ("collective-permute", "slice")
UNNAMED_GATHER = ("all-gather", "")

# the targets whose difference is only JAX's collectives of these classes
# (kind, op-name tail): count.  Every one of them equals its committed
# baseline when compiled here
JAX_ONLY = {
    "models/transformer.py::forward[dp,tp]": {QKV: 14},
    "serve/engine.py::prefill[dp,tp]": {QKV: 14},
    "serve/engine.py::prefill_chunk[dp,tp]": {QKV: 14},
    "serve/engine.py::decode_step[dp,tp]": {QKV: 14},
    "serve/engine.py::decode_step[int8,tp]": {QKV: 14},
    "models/transformer.py::forward[dp,tp,overlap=ring]": {QKV: 14, UNNAMED_GATHER: 1},
    "models/transformer.py::forward[dp,tp,overlap=bidir]": {QKV: 14, UNNAMED_GATHER: 1},
    "serve/engine.py::decode_fused[k4,dp,tp]": {QKV: 56, UNNAMED_GATHER: 1},
    "serve/engine.py::decode_fused_token[k4,dp,tp]": {QKV: 56, UNNAMED_GATHER: 1},
    "serve/engine.py::draft_scan[gamma4,dp,tp]": {QKV: 28, UNNAMED_GATHER: 1},
}
VERIFY = "serve/engine.py::verify_step[gamma4,dp,tp]"
ZERO0 = "train/loop.py::train_step[zero0,dp]"
ZERO1 = "train/loop.py::train_step[zero1,dp]"
OVERLAP_TRAIN = "train/loop.py::train_step[dp,tp,overlap=ring]"


def test_every_pin_is_covered():
    covered = set(JAX_ONLY) | {VERIFY, ZERO0, ZERO1, OVERLAP_TRAIN} | set(NATIVE_ROOTED)
    assert covered == set(INVENTORY_EXCEPTIONS)


def _compiled(name):
    """JAX's schedule meta of ``name`` compiled here, and its committed one."""
    target = next(t for t in jax_audit.default_targets() if t.name == name)
    _, meta = jax_audit.audit_target(target, passes=("hlo", "schedule"))
    committed = json.loads(jax_sched.baseline_path(JAX_BASELINES, name).read_text())
    return meta["schedule"], committed


def _inventory(sched):
    return sched["total_wire_bytes"], sched["num_collectives"], sched["collective_kinds"]


def _by_class(sched):
    """(kind, op-name tail) -> [execution-weighted count, wire bytes]."""
    out: dict = {}
    for c in sched["collectives"]:
        tail = (c.get("op_name") or "").rsplit("/", 1)[-1]
        row = out.setdefault((c["kind"], tail), [0, 0])
        row[0] += c["execution_count"]
        row[1] += c["execution_count"] * c["wire_bytes"]
    return out


def _rest(classes, drop=()):
    """(count, kinds, wire by kind) of the classes outside ``drop``."""
    kinds, wire = Counter(), Counter()
    for (kind, tail), (n, w) in classes.items():
        if (kind, tail) not in drop:
            kinds[kind] += n
            wire[kind] += w
    return sum(kinds.values()), dict(kinds), dict(wire)


@pytest.mark.parametrize("name", sorted(JAX_ONLY))
def test_difference_is_jax_reshard_collectives(name):
    """JAX's inventory less the named classes (the QKV slice permutes, 7
    per layer and trip; the unnamed entry or slot-vector all-gather) is the
    port's, collective for collective and byte for byte."""
    sched, committed = _compiled(name)
    assert _inventory(sched) == _inventory(committed)
    classes = _by_class(sched)
    for cls, n in JAX_ONLY[name].items():
        assert classes[cls][0] == n, cls
    _, wire, count, kinds, kind_wire = INVENTORY_EXCEPTIONS[name]
    assert _rest(classes, JAX_ONLY[name]) == (count, kinds, kind_wire)
    assert sum(kind_wire.values()) == wire


def test_verify_difference_is_the_open_fault():
    """The verify's all-reduces: JAX's 4 batched ones and the port's 20 (one
    per position, gamma + 1 = 5) move the same bytes; the port gathers two
    vectors where JAX gathers one (ROADMAP Queue 3 item 6)."""
    sched, committed = _compiled(VERIFY)
    assert _inventory(sched) == _inventory(committed)
    classes = _by_class(sched)
    assert classes[QKV][0] == 14
    _, kinds, wire = _rest(classes, {QKV})
    assert (kinds, wire) == ({"all-gather": 1, "all-reduce": 4},
                             {"all-gather": 8, "all-reduce": 15360})
    _, _, _, port_kinds, port_wire = INVENTORY_EXCEPTIONS[VERIFY]
    assert port_kinds["all-reduce"] == 5 * kinds["all-reduce"]
    assert port_wire["all-reduce"] == wire["all-reduce"]
    assert (port_kinds["all-gather"], port_wire["all-gather"]) == (2, 48)


def test_zero0_difference_is_the_all_reduce_count_only():
    """The committed HLO and this host's XLA count the same gradient wire
    in 27 and 3 all-reduces: the count is XLA's combiner's; the port moves
    that wire in 15."""
    sched, committed = _compiled(ZERO0)
    assert sched["total_wire_bytes"] == committed["total_wire_bytes"]
    assert (committed["num_collectives"], sched["num_collectives"]) == (27, 3)
    assert set(sched["collective_kinds"]) == set(committed["collective_kinds"]) == \
        {"all-reduce"}
    _, wire, _, kinds, kind_wire = INVENTORY_EXCEPTIONS[ZERO0]
    assert wire == committed["total_wire_bytes"] and set(kinds) == {"all-reduce"}


def test_zero1_difference_is_reduce_scatter_for_all_reduce():
    """JAX's all-gathers are the port's in count and bytes; JAX's
    all-reduces move the port's unsharded all-reduces plus twice its
    reduce-scatters: the sharded gradients all-reduced whole."""
    sched, committed = _compiled(ZERO1)
    assert sched["total_wire_bytes"] == committed["total_wire_bytes"]
    assert committed["collective_kinds"]["all-gather"] == \
        sched["collective_kinds"]["all-gather"] == 12
    _, kinds, wire = _rest(_by_class(sched))
    _, _, _, port_kinds, port_wire = INVENTORY_EXCEPTIONS[ZERO1]
    assert (kinds["all-gather"], wire["all-gather"]) == \
        (port_kinds["all-gather"], port_wire["all-gather"])
    assert wire["all-reduce"] == port_wire["all-reduce"] + 2 * port_wire["reduce-scatter"]
    assert port_kinds["reduce-scatter"] == kinds["all-gather"]


def test_overlap_train_difference_by_class():
    """This host's XLA no longer compiles the committed program (no
    all-to-all, fewer collectives).  Its all-reduces move the port's bytes
    in 6 combined ones; the QKV slice permutes and the pad all-gathers are
    JAX's own; its ring hops are 60 against the port's 72 (PERF.md section
    7)."""
    sched, committed = _compiled(OVERLAP_TRAIN)
    assert "all-to-all" in committed["collective_kinds"]
    assert "all-to-all" not in sched["collective_kinds"]
    classes = _by_class(sched)
    assert classes[QKV][0] == 14
    assert classes[("all-gather", "pad")][0] == 6
    hops = sum(n for (kind, tail), (n, _) in classes.items()
               if kind == "collective-permute" and tail == "ppermute")
    _, _, _, port_kinds, port_wire = INVENTORY_EXCEPTIONS[OVERLAP_TRAIN]
    assert (hops, port_kinds["collective-permute"]) == (60, 72)
    _, kinds, wire = _rest(classes)
    assert (kinds["all-reduce"], wire["all-reduce"]) == (6, port_wire["all-reduce"])
