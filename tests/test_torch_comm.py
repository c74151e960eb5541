"""The port's collectives (``dlbb_tpu_torch/comm``) against the JAX package's.

Every op runs on a gloo group of spawned ranks (world 4 on a ring, world 8
on the 2x4 and 2x2x2 grids), once per module, and each rank's input and
output slab comes back.  Stacked over the ranks, the outputs are held
against the JAX builder on the same global payload (the CPU-simulated mesh
of ``conftest.py``) and against the port's ``plain_collective``:

- data movement (allgather, broadcast, gather, scatter, alltoall, sendrecv)
  and max/min reductions: equal values, element for element;
- sums (allreduce, reduce, reducescatter, the barrier's psum, the
  hierarchical allreduce): P - 1 additions per element, each rounded once
  in the payload's dtype, put every result within gamma_{P-1} x sum|x_i| of
  the exact (float64) sum, gamma_n = n u / (1 - n u) with the unit
  roundoff u = 2**-8 (bf16) or 2**-24 (fp32); the port is held to that
  against the exact sum, and to twice it against JAX's and the plain
  version's results, which lie within the same bound on the other side;
- products: the same with |prod x_i| in place of sum|x_i|.

Rooted ops run at roots 0 and P - 1; gather and reduce must leave exact
zeros off the root.  Payloads match JAX's bit for bit.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_comm_worker

from dlbb_tpu.comm import MeshSpec as JaxMeshSpec
from dlbb_tpu.comm import build_mesh
from dlbb_tpu.comm import get_op as jax_get_op
from dlbb_tpu.comm import make_payload as jax_make_payload
from dlbb_tpu.comm.ops import OPERATIONS as JAX_OPERATIONS
from dlbb_tpu.comm.ops import build_allreduce as jax_allreduce
from dlbb_tpu.comm.ops import build_allreduce_hierarchical as jax_hierarchical
from dlbb_tpu.comm.ops import build_barrier as jax_barrier
from dlbb_tpu.comm.ops import build_reduce as jax_reduce
from dlbb_tpu.comm.variants import VARIANTS as JAX_VARIANTS
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.comm import Mesh, MeshSpec, get_op, make_payload, plain_collective
from dlbb_tpu_torch.comm import ops as port_ops
from dlbb_tpu_torch.comm import variants as port_variants

REPO = Path(__file__).resolve().parents[1]
ROADMAP = REPO / "ROADMAP.md"
N = 64
SHAPE_3D = (2, 3, 8)
RING4 = ((4,), ("ranks",))
GRID2X4 = ((2, 4), ("outer", "inner"))
GRID2X2X2 = ((2, 2, 2), ("x", "y", "z"))
UNIT_ROUNDOFF = {"bfloat16": 2.0**-8, "float32": 2.0**-24}
JAX_DTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
EXACT_OPS = ("allgather", "broadcast", "gather", "scatter", "alltoall", "sendrecv")
ROOTED = ("broadcast", "gather", "scatter", "reduce")


def _case(name, dtype, root=0, reduce_op="sum", shape=None, mesh=RING4):
    return (name, dtype, root, reduce_op, shape, mesh[0], mesh[1])


CASES4 = (
    [_case("allreduce", dt, reduce_op=r) for r in ("sum", "max", "min", "prod")
     for dt in UNIT_ROUNDOFF]
    + [_case(n, dt, root=root) for n in ROOTED for root in (0, 3)
       for dt in UNIT_ROUNDOFF]
    + [_case(n, dt) for n in ("allgather", "alltoall", "sendrecv", "reducescatter",
                              "barrier") for dt in UNIT_ROUNDOFF]
    + [_case("reduce", "float32", root=3, reduce_op=r) for r in ("max", "prod")]
    + [_case(n, "bfloat16", root=3, shape=SHAPE_3D)
       for n in ("allreduce", "allgather", "broadcast", "gather", "reduce")]
)
CASES8 = [_case(n, dt, mesh=m) for m in (GRID2X4, GRID2X2X2)
          for n in ("allreduce", "allreduce_hierarchical") for dt in UNIT_ROUNDOFF]


def _case_id(case):
    name, dtype, root, reduce_op, shape, mesh_shape, _ = case
    parts = [name, dtype, f"root{root}"]
    if reduce_op != "sum":
        parts.append(reduce_op)
    if shape is not None:
        parts.append("x".join(map(str, shape)))
    parts.append("mesh" + "x".join(map(str, mesh_shape)))
    return "-".join(parts)


@pytest.fixture(scope="module")
def world4():
    return launch(torch_comm_worker.run_cases, 4, "cpu", args=(CASES4, N), timeout=240)


@pytest.fixture(scope="module")
def world8():
    return launch(torch_comm_worker.run_cases, 8, "cpu", args=(CASES8, N), timeout=240)


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float64).numpy()


def _jax_output(case, devices):
    name, dtype, root, reduce_op, shape, mesh_shape, axis_names = case
    mesh = build_mesh(JaxMeshSpec(mesh_shape, axis_names))
    axes = axis_names
    kind = "allreduce" if name == "barrier" else name
    x = jax_make_payload(jax_get_op(kind), mesh, axes, N,
                         dtype=JAX_DTYPES[dtype], shape=shape)
    if name == "allreduce":
        fn = jax_allreduce(mesh, axes, root, reduce_op)
    elif name == "reduce":
        fn = jax_reduce(mesh, axes, root, reduce_op)
    elif name == "allreduce_hierarchical":
        fn = jax_hierarchical(mesh, axes)
    elif name == "barrier":
        fn = jax_barrier(mesh, axes)
    else:
        fn = jax_get_op(name).build(mesh, axes, root)
    return np.asarray(fn(x)).astype(np.float64)


def _check(case, ranks, devices):
    name, dtype, root, reduce_op, _, mesh_shape, _ = case
    p = int(np.prod(mesh_shape))
    x = torch.stack([ranks[r][case][0] for r in range(p)])
    port = _f64(torch.stack([ranks[r][case][1] for r in range(p)]))
    jax_out = _jax_output(case, devices)
    plain_name = "allreduce" if name == "barrier" else name
    plain = _f64(plain_collective(plain_name, x, root, reduce_op, mesh_shape))
    assert port.shape == jax_out.shape == plain.shape
    if name in ("gather", "reduce"):
        off_root = np.arange(p) != root
        assert np.all(port[off_root] == 0), "non-root output is not zero"
    if name in EXACT_OPS or reduce_op in ("max", "min"):
        np.testing.assert_array_equal(port, jax_out)
        np.testing.assert_array_equal(port, plain)
        return
    x64 = x.to(torch.float64)
    exact = _f64(plain_collective(plain_name, x64, root, reduce_op, mesh_shape))
    size = np.abs(exact) if reduce_op == "prod" else _f64(
        plain_collective(plain_name, x64.abs(), root, reduce_op, mesh_shape))
    n, u = p - 1, UNIT_ROUNDOFF[dtype]
    bound = n * u / (1 - n * u) * size
    assert np.all(np.abs(port - exact) <= bound), "port vs the exact float64 result"
    assert np.all(np.abs(port - jax_out) <= 2 * bound), "port vs JAX"
    assert np.all(np.abs(port - plain) <= 2 * bound), "port vs plain_collective"


@pytest.mark.parametrize("case", CASES4, ids=_case_id)
def test_op_matches_jax_and_plain_world4(case, world4, devices):
    _check(case, world4, devices)


@pytest.mark.parametrize("case", CASES8, ids=_case_id)
def test_op_matches_jax_and_plain_world8(case, world8, devices):
    _check(case, world8, devices)


@pytest.mark.parametrize("mesh", [GRID2X4, GRID2X2X2], ids=["2x4", "2x2x2"])
@pytest.mark.parametrize("dtype", list(UNIT_ROUNDOFF))
def test_hierarchical_allreduce_matches_flat(mesh, dtype, world8):
    """The per-axis allreduce equals the joint one (JAX's
    ``test_hierarchical_allreduce_matches_flat``), within twice the rounding
    bound of the module docstring."""
    flat, hier = _case("allreduce", dtype, mesh=mesh), _case(
        "allreduce_hierarchical", dtype, mesh=mesh)
    p = int(np.prod(mesh[0]))
    x = torch.stack([world8[r][flat][0] for r in range(p)]).to(torch.float64)
    got = {c: _f64(torch.stack([world8[r][c][1] for r in range(p)])) for c in (flat, hier)}
    n, u = p - 1, UNIT_ROUNDOFF[dtype]
    bound = 2 * n * u / (1 - n * u) * _f64(plain_collective("allreduce", x.abs()))
    assert np.all(np.abs(got[flat] - got[hier]) <= bound)


@pytest.mark.parametrize("shape", [None, SHAPE_3D], ids=["flat", "3d"])
@pytest.mark.parametrize("dtype", list(UNIT_ROUNDOFF))
@pytest.mark.parametrize("op_name", ["allreduce", "scatter"], ids=["per_rank", "per_peer"])
def test_payload_is_the_jax_slab_bit_for_bit(op_name, dtype, shape, devices):
    mesh = build_mesh(JaxMeshSpec.ring(4))
    glob = np.asarray(jax_make_payload(jax_get_op(op_name), mesh, ("ranks",), N,
                                       dtype=JAX_DTYPES[dtype], shape=shape))
    bits = np.int16 if dtype == "bfloat16" else np.int32
    tbits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert port_ops.payload_global_shape(get_op(op_name), 4, N, shape) == glob.shape
    for rank in range(4):
        slab = make_payload(get_op(op_name), rank, 4, N, dtype=dtype, shape=shape)
        assert tuple(slab.shape) == glob.shape[1:]
        np.testing.assert_array_equal(slab.view(tbits).numpy(), glob[rank].view(bits))


def test_registry_mirrors_jax():
    """Every JAX op is ported, with the same buffer kinds."""
    assert set(port_ops.OPERATIONS) == set(JAX_OPERATIONS)
    for name, op in port_ops.OPERATIONS.items():
        ref = JAX_OPERATIONS[name]
        assert (op.input_kind, op.output_kind, op.transient_kind) == (
            ref.input_kind, ref.output_kind, ref.transient_kind)


# a citation of ROADMAP's Queue 1: "Queue 1, Slice X[ remainder], item N"
CITATION = re.compile(r"Queue\s+1,\s+(Slice\s+[A-F](?:\s+remainder)?)(?:,\s+item\s+(\d+))?")


def roadmap_items() -> dict[str, set[int]]:
    """The numbered items of each slice of ROADMAP.md's Queue 1: a line
    ``**Slice X[ remainder]: ...**`` opens a slice, any other bold line at
    the start of a line closes it, and ``N. **...`` is its item N."""
    queue1 = ROADMAP.read_text().split("### Queue 1", 1)[1].split("### Queue 2", 1)[0]
    items: dict[str, set[int]] = {}
    section = None
    for line in queue1.splitlines():
        if line.startswith("**"):
            m = re.match(r"\*\*(Slice [A-F](?: remainder)?):", line)
            section = m.group(1) if m else None
            if section:
                items.setdefault(section, set())
        m = re.match(r"(\d+)\. \*\*", line)
        if m and section:
            items[section].add(int(m.group(1)))
    return items


def _citations(text: str) -> list[tuple[str, str, "int | None"]]:
    """(citation, slice, item or None) of every Queue 1 citation in text."""
    return [(m.group(0), " ".join(m.group(1).split()),
             int(m.group(2)) if m.group(2) else None)
            for m in CITATION.finditer(text)]


def _names_a_roadmap_item(message: str) -> None:
    """The refusal names ``Slice X[ remainder], item N`` and ROADMAP.md's
    Queue 1 has that slice's heading and a numbered item N under it."""
    found = _citations(message)
    assert found, message
    items = roadmap_items()
    for cited, section, item in found:
        assert item is not None and item in items.get(section, ()), cited


def _port_texts():
    """Each port file's string constants (docstrings included; adjacent
    literals joined, as Python joins them) and comments."""
    import ast
    import io
    import tokenize

    files = sorted((REPO / "dlbb_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    for path in files:
        src = path.read_text()
        texts = [n.value for n in ast.walk(ast.parse(src))
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)]
        texts += [tok.string for tok in tokenize.generate_tokens(io.StringIO(src).readline)
                  if tok.type == tokenize.COMMENT]
        yield path.relative_to(REPO).as_posix(), texts


def test_every_roadmap_citation_in_the_port_resolves():
    """Every "ROADMAP Queue 1, Slice X, item N" the port writes (refusals,
    docstrings, comments) names a numbered item of that slice in ROADMAP.md,
    so no refusal points the reader at a ported or renumbered item."""
    items = roadmap_items()
    assert {"Slice C remainder", "Slice D remainder", "Slice E", "Slice F"} <= set(items)
    seen = 0
    for rel, texts in _port_texts():
        for text in texts:
            for cited, section, item in _citations(text):
                seen += 1
                assert item is not None, f"{rel}: {cited!r} names no item"
                assert item in items.get(section, ()), f"{rel}: {cited!r} is not in ROADMAP"
    assert seen >= 10, seen


def test_unknown_op_raises():
    with pytest.raises(KeyError):
        get_op("allreduce_typo")


@pytest.mark.parametrize("name", sorted(port_variants.VARIANTS))
def test_variant_mesh_matches_jax(name):
    port, ref = port_variants.VARIANTS[name], JAX_VARIANTS[name]
    p = int(np.prod(ref.mesh_shape)) if ref.mesh_shape else 4
    assert port.hierarchical == ref.hierarchical
    assert port.overlap_schedule == ref.overlap_schedule
    assert (port.mesh_spec(p).shape, port.mesh_spec(p).axis_names) == (
        ref.mesh_spec(p).shape, ref.mesh_spec(p).axis_names)


@pytest.mark.parametrize("name", sorted(port_variants.NOT_PORTED))
def test_unported_variant_raises(name):
    assert name in JAX_VARIANTS and name not in port_variants.VARIANTS
    with pytest.raises(NotImplementedError, match="ROADMAP") as e:
        port_variants.get_variant(name)
    _names_a_roadmap_item(str(e.value))


@pytest.mark.parametrize("name", ["alltoall", "sendrecv", "reducescatter"])
def test_single_axis_ops_refuse_a_grid(name):
    """As in JAX, these ops need a single mesh axis."""
    grid = Mesh(MeshSpec((2, 4), ("outer", "inner")), 0, None, {})
    with pytest.raises(ValueError, match="single mesh axis"):
        get_op(name).build(grid)
