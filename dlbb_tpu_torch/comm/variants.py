"""Named tuning variants (counterpart of ``dlbb_tpu/comm/variants.py``).

The port has the mesh-shape variants (the flat ring and the 2-D and 3-D
grids, each either reduced jointly over the whole mesh or, as ``hier*``,
one axis subgroup at a time) and the overlap variants ``overlap_ring`` and
``overlap_bidir``, which run the collective-matmul micro-ops
``ag_matmul``/``matmul_rs`` on the decomposed schedules of
``parallel/collective_matmul.py`` (``default`` is their fused baseline),
and the quantised-wire variants ``compress_int8``, ``compress_fp8`` and
``compress_int8_bf16acc``, which set the wire dtype and the ring's
accumulation dtype of the micro-ops ``allreduce_q``/``reducescatter_q``
(``comm/compression.py``; ``default`` on ``allreduce``/``reducescatter``
is their uncompressed baseline), and ``nofuse``, the JAX package's
"collective combiners off": eager ``torch.distributed`` issues every call
on its own, so no combiner ever runs, and ``nofuse`` measures what
``default`` measures under its own label.  The variant's name lands in the
result JSON's ``implementation`` field, as in JAX.

``combine4mb`` and ``combine128mb`` are refused by name, never run as
``default``: in JAX they are combiner thresholds passed as ``XLA_FLAGS`` by
the pod launcher at process start, and eager NCCL has no combiner to set.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from dlbb_tpu_torch.comm.mesh import MeshSpec
from dlbb_tpu_torch.analysis.expectations import DEFAULT_COMPRESSION


@dataclass(frozen=True)
class Variant:
    """One named point in the tuning space."""

    name: str
    description: str = ""
    # mesh shape override; None = flat ring of the sweep's rank count
    mesh_shape: Optional[tuple[int, ...]] = None
    mesh_axis_names: Optional[tuple[str, ...]] = None
    # allreduce one axis subgroup at a time (build_allreduce_hierarchical)
    hierarchical: bool = False
    # collective-matmul schedule of the MATMUL_OPS ("ring" | "bidir"); None
    # keeps their fused default
    overlap_schedule: Optional[str] = None
    # wire dtype of the COMPRESSED_OPS ("int8" | "fp8"); None keeps their
    # default (``compressed_wire``).  Every other op ignores it, as
    # overlap_schedule
    compression: Optional[str] = None
    # accumulation dtype of the compressed ring ("float32" default,
    # "bfloat16" the reduced-precision variant)
    accum_dtype: Optional[str] = None

    def compressed_wire(self) -> tuple[str, str]:
        """(wire dtype, accumulation dtype) of the COMPRESSED_OPS under
        this variant, the ops' defaults where it sets none."""
        return self.compression or DEFAULT_COMPRESSION, self.accum_dtype or "float32"

    def mesh_spec(self, num_ranks: int) -> MeshSpec:
        if self.mesh_shape is None:
            return MeshSpec.ring(num_ranks)
        if math.prod(self.mesh_shape) != num_ranks:
            raise ValueError(f"variant {self.name!r} mesh {self.mesh_shape} "
                             f"does not cover {num_ranks} ranks")
        names = self.mesh_axis_names or tuple(
            f"ax{i}" for i in range(len(self.mesh_shape)))
        return MeshSpec(self.mesh_shape, names)


def _grid(shape: tuple[int, ...], hierarchical: bool) -> Variant:
    names = ("x", "y", "z") if len(shape) == 3 else ("outer", "inner")
    label = "x".join(map(str, shape))
    how = ("per-axis hierarchical allreduce, "
           + " then ".join(f"{a}({s})" for a, s in zip(names, shape))
           if hierarchical else "joint reduction over all axes")
    return Variant(f"{'hier' if hierarchical else 'grid'}{label}",
                   f"{label} mesh, {how}", mesh_shape=shape,
                   mesh_axis_names=names, hierarchical=hierarchical)


VARIANTS: dict[str, Variant] = {
    "default": Variant("default", "flat 1D ring, the backend's own algorithm"),
    "ring": Variant("ring", "flat 1D ring (the JAX package's CCL_ALLREDUCE=ring "
                            "analogue; the same mesh as default here)"),
    **{v.name: v for shape in ((2, 4), (4, 2), (2, 8), (4, 4), (2, 2, 2))
       for v in (_grid(shape, False), _grid(shape, True))},
    "overlap_ring": Variant(
        "overlap_ring",
        "ring-decomposed collective matmul: a chain of neighbour hops hides "
        "the gather/scatter behind per-shard partial matmuls (ag_matmul / "
        "matmul_rs micro-ops; fused baseline = the default variant)",
        overlap_schedule="ring"),
    "overlap_bidir": Variant(
        "overlap_bidir",
        "bidirectional-ring collective matmul: both ring directions per "
        "step — half the hops for ag_matmul, half-sized messages both "
        "ways for matmul_rs",
        overlap_schedule="bidir"),
    "compress_int8": Variant(
        "compress_int8",
        "quantised-wire collectives: int8 chunked-symmetric wire, fp32 "
        "accumulation (allreduce_q / reducescatter_q micro-ops; bf16 "
        "fused baseline = the default variant on allreduce/reducescatter)",
        compression="int8"),
    "compress_fp8": Variant(
        "compress_fp8",
        "quantised-wire collectives: fp8(e4m3) wire, fp32 accumulation — "
        "same byte footprint as int8, different rounding behaviour",
        compression="fp8"),
    "compress_int8_bf16acc": Variant(
        "compress_int8_bf16acc",
        "int8 wire with bf16 ring accumulation — the reduced-precision "
        "accumulate leg of the bandwidth-vs-accuracy axis",
        compression="int8", accum_dtype="bfloat16"),
    "nofuse": Variant(
        "nofuse",
        "collective combiners off (the JAX package's CCL_FUSION_ENABLE=0 "
        "analogue): eager torch.distributed issues every call on its own, so "
        "no combiner runs, as under default"),
}

# variants of the JAX package that are not ported, and why
NOT_PORTED: dict[str, str] = {
    name: "the all-reduce combiner threshold is a process-start XLA_FLAGS "
          "option that the JAX package's pod launcher sets; eager NCCL "
          "combines no collectives, so the threshold has no counterpart "
          "(ROADMAP Queue 1, Slice C remainder, item 8)"
    for name in ("combine4mb", "combine128mb")
}


def get_variant(name: str) -> Variant:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"variant {name!r} is not ported: {NOT_PORTED[name]}")
    try:
        return VARIANTS[name]
    except KeyError:
        raise KeyError(f"unknown variant {name!r}; known: {sorted(VARIANTS)}") from None
