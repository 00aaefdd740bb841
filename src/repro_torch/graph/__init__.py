"""Graph compiler front end: DAG IR + pass pipeline (DESIGN.md §Graph).

The paper's compiler stops at strictly sequential CNNs; this subpackage
opens branching topologies (residual blocks) with a small, verifiable
stack:

* :mod:`repro_torch.graph.ir`     — the DAG IR (nodes for conv/fc/relu/pool/
  requant/add/flatten, explicit named tensor values, topological
  verification) and its declarative :class:`~repro_torch.graph.ir.GraphBuilder`;
* :mod:`repro_torch.graph.passes` — shape inference, requant-shift planning
  across branch joins, linearization into fused steps — each pass with a
  declared, unit-tested invariant;
* :mod:`repro_torch.graph.lower`  — lowering onto the existing layer/network
  compilers, with residual adds executed *on the VTA* as ALU vector-vector
  ADD instructions.
"""

from .ir import Graph, GraphBuilder, Node                       # noqa: F401
from .passes import (RequantPlan, Step, evaluate_graph,          # noqa: F401
                     infer_shapes, linearize, plan_requant)
from .lower import compile_graph                                 # noqa: F401
