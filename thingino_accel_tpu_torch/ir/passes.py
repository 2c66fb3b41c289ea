"""Graph passes the port runs: ``fuse_silu_pairs``, ``fuse_act_into_conv``
and ``fold_batchnorm`` (and ``dead_code``, which ``Graph.with_outputs``
calls), copied from ``thingino_accel_tpu/ir/passes.py``.

- ``fuse_silu_pairs``: SIGMOID(x) + MUL(x, sig) -> SILU_FUSED (x*σ(x) in
  one f32 expression with a single requant).
- ``fuse_act_into_conv``: a standalone activation folded into the conv
  before it (the serving tier's epilogue).
- ``fold_batchnorm``: BATCHNORM following CONV2D folded into conv weights
  (f32 graphs).
- ``dead_code``: drop nodes whose outputs are never consumed.
"""

from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

from thingino_accel_tpu_torch.ir.graph import Graph, Node, TensorInfo


def fuse_silu_pairs(graph: Graph) -> List[Node]:
    """Return a rewritten node list with SIGMOID+MUL pairs fused.

    Pattern: ``s = SIGMOID(x)``, ``y = MUL(x, s)`` (either operand order)
    where ``s`` has no other consumer. Scales of the pair are preserved in
    the fused node's attrs for exact-ish int8 replication.
    """
    consumers = graph.consumers()
    nodes = list(graph.nodes)
    out_set = set(graph.outputs)
    producer: Dict[str, Node] = graph.producer_map()

    fused: List[Node] = []
    skip: Set[int] = set()
    for idx, node in enumerate(nodes):
        if idx in skip:
            continue
        if node.op == "SIGMOID":
            sig_out = node.outputs[0]
            cons = consumers.get(sig_out, [])
            if (len(cons) == 1 and cons[0].op == "MUL"
                    and sig_out not in out_set):
                mul = cons[0]
                other = [i for i in mul.inputs if i != sig_out]
                if len(other) == 1 and other[0] == node.inputs[0]:
                    x = node.inputs[0]
                    fused.append(Node(
                        op="SILU_FUSED",
                        inputs=[x],
                        outputs=list(mul.outputs),
                        attrs=dict(
                            in_scale=graph.tensors[x].quant.scale,
                            sig_scale=graph.tensors[sig_out].quant.scale,
                            out_scale=graph.tensors[mul.outputs[0]].quant.scale,
                        ),
                        name=f"{node.name}+{mul.name}",
                    ))
                    skip.add(nodes.index(mul))
                    continue
        fused.append(node)
    return fused


def fuse_act_into_conv(graph: Graph) -> Graph:
    """Fold a standalone activation node (RELU / LEAKY_RELU / SILU /
    SILU_FUSED) into the preceding CONV2D's ``activation`` attr when the
    conv feeds only that node.

    The serving tier's fused conv kernels apply the activation on the
    f32 pre-activation inside the requantize epilogue — one intermediate
    quantization fewer than the interpreter pipeline (reference analog:
    the format's fused-activation field, ``include/mars.h:82-91``, which
    the C runtime only honors for RELU, ``mars_runtime.c:701-707``).
    Applies :func:`fuse_silu_pairs` first so SIGMOID+MUL pairs fold too.
    Operates on a node-copied graph: Node objects may be shared with
    other engines built over the same Graph, and this pass rewires conv
    outputs in place.
    """
    graph = Graph(
        nodes=[Node(op=n.op, inputs=list(n.inputs),
                    outputs=list(n.outputs), attrs=dict(n.attrs),
                    name=n.name) for n in graph.nodes],
        tensors=graph.tensors, inputs=list(graph.inputs),
        outputs=list(graph.outputs), name=graph.name)
    graph.nodes = fuse_silu_pairs(graph)
    consumers = graph.consumers()
    producer = graph.producer_map()
    out_set = set(graph.outputs)
    fusable = {"RELU": "RELU", "LEAKY_RELU": "LEAKY_RELU",
               "SILU": "SILU", "SILU_FUSED": "SILU"}
    remove = set()
    for i, node in enumerate(graph.nodes):
        act = fusable.get(node.op)
        if act is None:
            continue
        src = node.inputs[0]
        prod = producer.get(src)
        if (prod is None or prod.op != "CONV2D"
                or prod.attrs.get("activation", "NONE") != "NONE"
                or prod.attrs.get("dilation", (1, 1)) != (1, 1)
                or len(consumers.get(src, [])) != 1
                or src in out_set):
            continue
        prod.attrs["activation"] = act
        if node.op == "LEAKY_RELU":
            prod.attrs["alpha"] = node.attrs.get("alpha", 0.01) or 0.01
        prod.outputs = list(node.outputs)
        remove.add(i)
    if remove:
        graph.nodes = [n for i, n in enumerate(graph.nodes)
                       if i not in remove]
    return graph


def fold_batchnorm(graph: Graph) -> Graph:
    """Fold BATCHNORM(conv_out) into the preceding f32 CONV2D's weights.

    y = (conv(x, W) + b) * s + t  ==  conv(x, W*s) + (b*s + t)
    Only applied when the conv output feeds just the BN, is not itself a
    graph output, and both ops are f32. Non-destructive: folded weights
    and biases go into FRESH tensors and the conv is REPLACED, never
    mutated — Graph copies share Node/TensorInfo objects (see
    fuse_act_into_conv's docstring), so an in-place fold would
    double-apply the BN scale if the same source graph builds two
    engines.
    """
    consumers = graph.consumers()
    producer = graph.producer_map()
    out_set = set(graph.outputs)
    nodes = list(graph.nodes)
    idx_of = {id(n): i for i, n in enumerate(nodes)}
    remove: Set[int] = set()
    replace: Dict[int, Node] = {}

    for i, node in enumerate(nodes):
        if node.op != "BATCHNORM" or len(node.inputs) < 3:
            continue
        src = node.inputs[0]
        if src in out_set:
            continue   # conv output must stay produced
        prod = producer.get(src)
        if prod is None or prod.op != "CONV2D":
            continue
        pi = idx_of.get(id(prod))
        if pi is None or pi in replace:
            continue
        if len(consumers.get(src, [])) != 1:
            continue
        wt = graph.tensors.get(prod.inputs[1]) if len(prod.inputs) > 1 else None
        sc_t = graph.tensors.get(node.inputs[1])
        bi_t = graph.tensors.get(node.inputs[2])
        if wt is None or wt.data is None or sc_t is None or bi_t is None:
            continue
        if wt.data.dtype != np.float32:
            continue
        s = sc_t.data.reshape(-1).astype(np.float32)
        t = bi_t.data.reshape(-1).astype(np.float32)
        w_name = f"{prod.inputs[1]}__bnf{i}"
        graph.tensors[w_name] = TensorInfo(
            name=w_name, shape=wt.shape, dtype=wt.dtype,
            data=wt.data * s[:, None, None, None])
        if len(prod.inputs) > 2:
            b_new = graph.tensors[prod.inputs[2]].data \
                .astype(np.float32) * s + t
        else:
            b_new = t.copy()
        b_name = f"{prod.name}__bnf{i}_b"
        graph.tensors[b_name] = TensorInfo(
            name=b_name, shape=b_new.shape, dtype=np.dtype(np.float32),
            data=b_new)
        # the replacement conv writes what BN wrote
        replace[pi] = Node(
            op="CONV2D", inputs=[prod.inputs[0], w_name, b_name],
            outputs=list(node.outputs), attrs=dict(prod.attrs),
            name=prod.name)
        remove.add(i)

    if remove:
        graph.nodes = [replace.get(j, n) for j, n in enumerate(nodes)
                       if j not in remove]
    return graph


def dead_code(graph: Graph) -> Graph:
    """Remove nodes whose outputs reach no graph output."""
    live: Set[str] = set(graph.outputs)
    keep: List[Node] = []
    for node in reversed(graph.nodes):
        if any(o in live for o in node.outputs):
            keep.append(node)
            live.update(node.inputs)
    graph.nodes = list(reversed(keep))
    return graph
