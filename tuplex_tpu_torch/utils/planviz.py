"""The plan as text and as a graph (counterpart of
`tuplex_tpu/utils/planviz.py`; reference: core/src/Context.cc:171
visualizeOperationGraph, LocalBackend.cc:932-949 stage logs).

`explain` prints the physical plan the way the reference does, without
its code statistics and graph-vetting lines (the port has neither);
`plan_to_dot` writes the operator DAG as graphviz DOT text.
"""

from __future__ import annotations


def _op_label(op) -> str:
    bits = [type(op).__name__.replace("Operator", "")]
    col = getattr(op, "column", None)
    if col:
        bits.append(repr(col))
    udf = getattr(op, "udf", None)
    if udf is not None and udf.source:
        src = udf.source.replace('"', "'")
        if len(src) > 40:
            src = src[:37] + "..."
        bits.append(src)
    return "\\n".join(bits)


def plan_to_dot(sink) -> str:
    """The operator DAG as graphviz DOT text (`dot -Tpdf` renders it)."""
    lines = ["digraph plan {", "  rankdir=BT;",
             '  node [shape=box, fontname="monospace", fontsize=10];']
    seen: set[int] = set()

    def walk(op):
        if op.id in seen:
            return
        seen.add(op.id)
        lines.append(f'  n{op.id} [label="#{op.id} {_op_label(op)}"];')
        for p in op.parents:
            walk(p)
            lines.append(f"  n{p.id} -> n{op.id};")

    walk(sink)
    lines.append("}")
    return "\n".join(lines)


def explain(sink, options=None) -> str:
    """The physical plan (plan/physical.py `plan_stages` under `options`):
    a head line per stage, its routing reason where the planner sent it
    to the interpreter, the source of the first stage, then one line per
    operator."""
    from ..plan.physical import plan_stages

    out = []
    for i, st in enumerate(plan_stages(sink, options)):
        head = f"Stage {i} [{type(st).__name__}]"
        if getattr(st, "force_interpret", False):
            head += " (interpreter segment)"
        out.append(head)
        reason = getattr(st, "route_reason", "")
        if reason:
            out.append(f"  routed: {reason}")
        # a later stage's `source` is the operator whose output it reads
        if i == 0 and st.source is not None:
            out.append("  source: "
                       + type(st.source).__name__.replace("Operator", ""))
        for op in getattr(st, "ops", []):
            out.append(f"  - #{op.id} "
                       + _op_label(op).replace("\\n", " "))
    return "\n".join(out)
