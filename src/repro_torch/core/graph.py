"""Kernel-level computation graph IR (the *input* to the MPK compiler).

Nodes are tensor-algebra operators (matmul, attention, rmsnorm, collectives,
...); edges are named tensors.  ``core.lowering`` builds these graphs from
model configs; ``core.compile`` lowers them to SM-level tGraphs (paper §4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .regions import TensorSpec

__all__ = ["OpKind", "OpNode", "ComputationGraph"]


class OpKind:
    """Operator kinds understood by decomposition, the interpreter and the
    megakernel task library.  String constants (not an Enum) so graphs stay
    trivially serializable."""

    # compute
    EMBED_LOOKUP = "embed_lookup"
    RMSNORM = "rmsnorm"
    MATMUL = "matmul"
    ROPE = "rope"
    ATTENTION_DECODE = "attention_decode"
    ATTENTION_PREFILL = "attention_prefill"
    GLU_MUL = "glu_mul"            # silu(gate) * up   (or gelu for GeGLU)
    RESIDUAL_ADD = "residual_add"
    ELEMENTWISE = "elementwise"
    SOFTMAX_TOPK = "softmax_topk"  # MoE router activation
    MOE_GATHER_GEMM = "moe_gather_gemm"  # fused gather + expert GEMM (§6.4)
    MOE_COMBINE = "moe_combine"
    SSM_UPDATE = "ssm_update"      # Mamba2 decode state update
    CONV1D_UPDATE = "conv1d_update"
    CACHE_UPDATE = "cache_update"  # write the new token's K/V at seq_lens
    NOOP = "noop"                  # dummy task inserted by normalization
    # communication (orange tasks in the paper)
    ALLREDUCE = "allreduce"
    ALLGATHER = "allgather"
    REDUCE_SCATTER = "reduce_scatter"
    ALLTOALL = "alltoall"

    COMM_KINDS = frozenset({ALLREDUCE, ALLGATHER, REDUCE_SCATTER, ALLTOALL})
    # operators whose execution time is data dependent -> JIT launch (§5.2)
    DATA_DEPENDENT_KINDS = frozenset(
        {ATTENTION_DECODE, ATTENTION_PREFILL, MOE_GATHER_GEMM, MOE_COMBINE}
    )


@dataclasses.dataclass
class OpNode:
    op_id: int
    kind: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: "jit" | "aot" — assigned by the compiler's hybrid-launch classifier
    launch_mode: str = "aot"

    @property
    def is_comm(self) -> bool:
        return self.kind in OpKind.COMM_KINDS

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Op{self.op_id}<{self.kind}>({','.join(self.inputs)})->({','.join(self.outputs)})"


class ComputationGraph:
    """SSA-ish op graph: every tensor has at most one producer."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.tensors: Dict[str, TensorSpec] = {}
        self.ops: List[OpNode] = []
        self.producer: Dict[str, int] = {}           # tensor -> op_id
        self.consumers: Dict[str, List[int]] = {}    # tensor -> [op_id]
        self.inputs: List[str] = []                  # graph inputs (params/acts)
        self.outputs: List[str] = []

    # ------------------------------------------------------------------ build
    def add_tensor(
        self,
        name: str,
        shape: Sequence[int],
        dtype: str = "bfloat16",
        is_input: bool = False,
    ) -> TensorSpec:
        if name in self.tensors:
            raise ValueError(f"duplicate tensor {name!r}")
        spec = TensorSpec(name, tuple(int(s) for s in shape), dtype)
        self.tensors[name] = spec
        self.consumers.setdefault(name, [])
        if is_input:
            self.inputs.append(name)
        return spec

    def add_op(
        self,
        kind: str,
        inputs: Sequence[str],
        outputs: Sequence[str],
        **attrs: Any,
    ) -> OpNode:
        for t in inputs:
            if t not in self.tensors:
                raise KeyError(f"unknown input tensor {t!r} for op {kind}")
        for t in outputs:
            if t not in self.tensors:
                raise KeyError(f"unknown output tensor {t!r} for op {kind}")
            if t in self.producer:
                raise ValueError(f"tensor {t!r} already has a producer")
        op = OpNode(len(self.ops), kind, tuple(inputs), tuple(outputs), dict(attrs))
        self.ops.append(op)
        for t in outputs:
            self.producer[t] = op.op_id
        for t in inputs:
            self.consumers[t].append(op.op_id)
        return op

    def mark_output(self, name: str) -> None:
        if name not in self.tensors:
            raise KeyError(name)
        self.outputs.append(name)

    # ------------------------------------------------------------------ query
    def op(self, op_id: int) -> OpNode:
        return self.ops[op_id]

    def spec(self, name: str) -> TensorSpec:
        return self.tensors[name]

    def edges(self) -> List[Tuple[int, int, str]]:
        """(producer_op, consumer_op, tensor) triples."""
        out = []
        for t, prod in self.producer.items():
            for cons in self.consumers.get(t, ()):
                out.append((prod, cons, t))
        return out

    def validate(self) -> None:
        """Cheap structural invariants; raises on violation."""
        for op in self.ops:
            for t in op.inputs:
                assert t in self.tensors
            for t in op.outputs:
                assert self.producer[t] == op.op_id
        # acyclicity via topological order over op dependencies
        order = self.topo_order()
        assert len(order) == len(self.ops), "graph has a cycle"

    def topo_order(self) -> List[int]:
        indeg = {op.op_id: 0 for op in self.ops}
        succ: Dict[int, List[int]] = {op.op_id: [] for op in self.ops}
        for prod, cons, _t in self.edges():
            if prod == cons:
                continue
            succ[prod].append(cons)
            indeg[cons] += 1
        # de-dup multi-edges
        for k in succ:
            succ[k] = sorted(set(succ[k]))
        indeg = {op.op_id: 0 for op in self.ops}
        for prod in succ:
            for cons in succ[prod]:
                indeg[cons] += 1
        ready = [i for i, d in sorted(indeg.items()) if d == 0]
        order: List[int] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in succ[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        return order

    def stats(self) -> Dict[str, Any]:
        return {
            "num_ops": len(self.ops),
            "num_tensors": len(self.tensors),
            "num_comm_ops": sum(1 for o in self.ops if o.is_comm),
            "num_edges": len(self.edges()),
        }

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ComputationGraph({self.name}: {len(self.ops)} ops, {len(self.tensors)} tensors)"
