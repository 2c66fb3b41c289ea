"""Serving-tier planner: which convs fuse with which neighbours.

Port of ``thingino_accel_tpu.runtime.executor`` ``_FoldPlan``,
``_plan_folds`` and ``_plan_epilogue_fusions``, decision for decision.

The fold factors and the stem stage are kept **as plan data only**: the
port runs every tensor in logical NHWC, but the JAX planner gates its
fusions on them (a CONCAT whose inputs' folds differ is materialized,
not fused), so the port must compute the same factors to fuse the same
ops. What only moves bytes on the TPU (``fold_layout``,
``unfold_layout``, ``repack_weights_*``, the ``qbf16x`` stage exit
behind ``TAT_QBF16_EXIT``) is not ported; ``TAT_STEM_NOGROW`` and
``TAT_QBF16_EXIT`` take their defaults (grow the stage; no ``qbf16x``).

The fusions the plan records:

- ``res_fuse``: ``ADD(conv_out, r)`` runs in the conv's epilogue;
- ``virtual_concat``: a CONCAT consumed only by 1x1/s1 convs is never
  materialized (each consumer sums per-part products);
- ``sppf``: ``CONCAT(y, m1, m2, m3)`` over a chain of KxK/1 maxpools runs
  in one kernel with its 1x1 consumer;
- ``bneck``: a 1x1 conv whose only consumer is a KxK/1 conv runs as one
  kernel with it (the C3 bottleneck), intermediate on chip.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from thingino_accel_tpu_torch.ir.graph import Node, TensorInfo
from thingino_accel_tpu_torch.ops import reference as R

FOLD_ELTWISE = ("RELU", "RELU6", "LEAKY_RELU", "SILU", "SILU_FUSED",
                 "SIGMOID", "CLIP")
_EPILOGUE_ACTS = ("NONE", "RELU", "LEAKY_RELU", "SILU")


def is_int8(t: TensorInfo) -> bool:
    return np.issubdtype(t.dtype, np.signedinteger) and t.dtype.itemsize == 1


def pool_pads(a: Dict[str, Any], in_hw=None
              ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((pt, pb), (pl, pr)) of a pool node: EXPLICIT as given, SAME split
    like the convs' (out = ceil(in / stride)), otherwise none."""
    ep = a.get("explicit_pad", (0, 0, 0, 0))
    if a.get("padding") == "EXPLICIT":
        return (ep[0], ep[1]), (ep[2], ep[3])
    if a.get("padding") == "SAME" and in_hw is not None:
        kh, kw = a.get("kernel", (1, 1))
        sh, sw = a.get("stride", (1, 1))
        ph = max(0, (-(-in_hw[0] // sh) - 1) * sh + kh - in_hw[0])
        pw = max(0, (-(-in_hw[1] // sw) - 1) * sw + kw - in_hw[1])
        return (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)
    return (0, 0), (0, 0)


class FoldPlan:
    """The plan of one graph; field names as in the JAX ``_FoldPlan``."""

    def __init__(self):
        self.fold: Dict[str, int] = {}      # planned fold per tensor
        self.parts: Dict[str, tuple] = {}   # channel-concat structure
        self.stem_stage: set = set()        # conv OUTPUT names in stage
        self.stem_emit: Dict[str, str] = {}  # out name -> "qbf16"|"int8"
        self.consumers: Dict[str, list] = {}
        self.res_fuse: Dict[str, tuple] = {}   # conv out -> (add, other)
        self.virtual_concat: Dict[str, list] = {}  # concat out -> inputs
        self.sppf: Dict[str, tuple] = {}    # concat out -> (src, k)
        self.bneck: Dict[str, tuple] = {}   # m name -> (convA, convB)
        self.pool_of: Dict[str, tuple] = {}  # skipped pool -> (src, k)
        self.skip_outputs: set = set()      # folded into a consumer

    def f(self, name: str) -> int:
        return self.fold.get(name, 1)


def conv_fold_eligible(node: Node, tensors) -> bool:
    if node.op != "CONV2D" or len(node.inputs) < 2:
        return False
    a = node.attrs
    in_t = tensors[node.inputs[0]]
    out_t = tensors[node.outputs[0]]
    if not (is_int8(in_t) and is_int8(out_t)):
        return False
    if a.get("dilation", (1, 1)) != (1, 1):
        return False
    st = a.get("stride", (1, 1))
    if st[0] != st[1]:
        return False
    if a.get("groups", 1) != 1:
        return False
    if len(in_t.shape) != 4 or 0 in in_t.shape or 0 in out_t.shape:
        return False
    return True


def plan_folds(nodes, tensors, graph_outputs) -> FoldPlan:
    """Port of ``_plan_folds``: the stem stage, the fold factors, then
    :func:`plan_epilogue_fusions`."""
    plan = FoldPlan()
    consumers: Dict[str, list] = {}
    for node in nodes:
        for i in node.inputs:
            consumers.setdefault(i, []).append(node)

    def stage_eligible(node, cin_limit):
        if not conv_fold_eligible(node, tensors):
            return False
        a = node.attrs
        k = a.get("kernel", (1, 1))
        cin = tensors[node.inputs[0]].shape[3]
        return (cin < cin_limit and k[0] * k[1] * cin <= 1024
                and a.get("activation", "NONE") in _EPILOGUE_ACTS)

    # seed: thin graph-input convs; grow: thin convs consuming the stage
    stage = {n.outputs[0] for n in nodes if stage_eligible(n, 16)}
    grown = True
    while grown:
        grown = False
        for node in nodes:
            out = node.outputs[0]
            if (out not in stage and stage_eligible(node, 48)
                    and tensors[node.inputs[0]].shape[3] >= 16
                    and node.inputs[0] in stage):
                stage.add(out)
                grown = True

    def emits(st):
        em = {}
        for node in nodes:
            out = node.outputs[0]
            if out not in st:
                continue
            cons = consumers.get(out, [])
            qb = bool(cons) and all(
                c.op == "CONV2D" and c.outputs[0] in st
                and c.inputs[0] == out for c in cons)
            em[out] = "qbf16" if qb else "int8"
        return em

    while True:   # prune: a grown conv needs a qbf16-emitting source
        em = emits(stage)
        drop = {n.outputs[0] for n in nodes
                if n.outputs[0] in stage
                and tensors[n.inputs[0]].shape[3] >= 16
                and em.get(n.inputs[0]) == "int8"}
        if not drop:
            break
        stage -= drop
    plan.stem_stage = stage
    plan.stem_emit = emits(stage)

    for node in nodes:
        out = node.outputs[0]
        if conv_fold_eligible(node, tensors):
            a = node.attrs
            s = a.get("stride", (1, 1))[0]
            cin = tensors[node.inputs[0]].shape[3]
            o = tensors[out].shape[3]
            ow = tensors[out].shape[2]
            if out in plan.stem_stage:
                if plan.stem_emit[out] == "qbf16":
                    continue   # no fold inside the stage
                f = next((c for c in (4, 2)
                          if c * o <= 128 and ow % c == 0), 1)
            elif cin < 16:   # stem: seed the fold chain from the output
                f = next((c for c in (4, 2)
                          if c * o <= 128 and ow % c == 0), 1)
            else:
                fin = plan.f(node.inputs[0])
                f = fin // s if (fin % s == 0 and fin >= s) else 1
                if f > 1 and ow % f:
                    f = 1
            plan.fold[out] = f
            plan.parts[out] = (o,)
        elif node.op in ("ADD", "MUL") and len(node.inputs) == 2:
            fa, fb = plan.f(node.inputs[0]), plan.f(node.inputs[1])
            pa = plan.parts.get(node.inputs[0])
            pb = plan.parts.get(node.inputs[1])
            if fa == fb and fa > 1 and pa == pb:
                plan.fold[out] = fa
                plan.parts[out] = pa
        elif node.op in FOLD_ELTWISE:
            f = plan.f(node.inputs[0])
            if f > 1:
                plan.fold[out] = f
                plan.parts[out] = plan.parts.get(node.inputs[0])
        elif node.op == "CONCAT":
            fs = [plan.f(i) for i in node.inputs]
            shp = [tensors[i].shape for i in node.inputs]
            same_hw = all(len(sh) == 4 and sh[:3] == shp[0][:3]
                          for sh in shp)
            tot = sum(sh[3] for sh in shp) if same_hw else -1
            if (same_hw and len(set(fs)) == 1 and fs[0] > 1
                    and len(tensors[out].shape) == 4
                    and tensors[out].shape[3] == tot):
                plan.fold[out] = fs[0]
                ps = []
                for i in node.inputs:
                    ps.extend(plan.parts.get(i, (tensors[i].shape[3],)))
                plan.parts[out] = tuple(ps)

    plan.consumers = consumers
    plan_epilogue_fusions(nodes, tensors, plan, consumers, set(graph_outputs))
    return plan


def plan_epilogue_fusions(nodes, tensors, plan: FoldPlan, consumers,
                          graph_outputs) -> None:
    """Port of ``_plan_epilogue_fusions``: residual adds, virtual concats
    (upgraded to SPPF where the pattern holds) and bottleneck pairs."""
    by_out = {n.outputs[0]: n for n in nodes if n.outputs}

    def conv_1x1_fused_ok(c_node, src):
        a = c_node.attrs
        return (c_node.op == "CONV2D" and c_node.inputs
                and c_node.inputs[0] == src
                and conv_fold_eligible(c_node, tensors)
                and c_node.outputs[0] not in plan.stem_stage
                and a.get("kernel", (1, 1)) == (1, 1)
                and a.get("stride", (1, 1)) == (1, 1)
                and a.get("activation", "NONE") in _EPILOGUE_ACTS)

    # residual adds (not LEAKY: its alpha applies on the quantized value)
    for node in nodes:
        out = node.outputs[0]
        if not conv_fold_eligible(node, tensors) \
                or out in plan.stem_stage:
            continue
        if node.attrs.get("activation", "NONE") not in (
                "NONE", "RELU", "SILU"):
            continue
        cons = consumers.get(out, [])
        if out in graph_outputs:
            continue   # the conv's own tensor must stay materialized
        if len(cons) != 1 or cons[0].op != "ADD" \
                or len(cons[0].inputs) != 2:
            continue
        add = cons[0]
        other = add.inputs[0] if add.inputs[1] == out else add.inputs[1]
        if other == out:
            continue   # ADD(x, x)
        o_ch = tensors[out].shape[3]
        ot = tensors.get(other)
        at = tensors.get(add.outputs[0])
        if ot is None or at is None or not (is_int8(ot) and is_int8(at)):
            continue
        if tuple(ot.shape) != tuple(tensors[out].shape):
            continue
        if plan.f(other) != plan.f(out):
            continue
        p_other = plan.parts.get(other, (ot.shape[3],))
        if tuple(ci for ci in p_other if ci > 0) != (o_ch,):
            continue
        plan.res_fuse[out] = (add, other)
        plan.skip_outputs.add(add.outputs[0])

    # virtual concats (+ SPPF upgrade)
    for node in nodes:
        if node.op != "CONCAT" or not node.outputs:
            continue
        out = node.outputs[0]
        cons = consumers.get(out, [])
        if not cons or not all(conv_1x1_fused_ok(c, out) for c in cons):
            continue
        shp = [tensors[i].shape for i in node.inputs]
        if not all(len(sh) == 4 and sh[:3] == shp[0][:3] for sh in shp):
            continue
        if len({plan.f(i) for i in node.inputs}) != 1:
            continue
        plan.virtual_concat[out] = list(node.inputs)
        plan.skip_outputs.add(out)

        # SPPF: inputs (y, m1, m2, m3), a maxpool chain, fold 1
        ins = node.inputs
        if len(ins) == 4 and plan.f(ins[0]) == 1:
            ms = [by_out.get(i) for i in ins[1:]]
            k0 = ms[0].attrs.get("kernel") if ms[0] is not None else None
            chain_src = [ins[0], ins[1], ins[2]]

            def is_pool(mn, src):
                if mn is None or mn.op != "MAXPOOL" or mn.inputs[0] != src:
                    return False
                a = mn.attrs
                t_in = tensors[mn.inputs[0]]
                t_out = tensors[mn.outputs[0]]
                if k0 is None:
                    return False
                p = (k0[0] - 1) // 2
                if pool_pads(a) != ((p, p), (p, p)):
                    return False   # the kernel assumes centred SAME
                return (a.get("kernel") == k0
                        and a.get("kernel", (1, 1))[0]
                        == a.get("kernel", (1, 1))[1]
                        and a.get("kernel", (1, 1))[0] % 2 == 1
                        and a.get("stride") == (1, 1)
                        and tuple(t_in.shape) == tuple(t_out.shape)
                        and abs(t_in.quant.scale - t_out.quant.scale)
                        < 1e-12)
            pool_only = all(is_pool(mn, src)
                            for mn, src in zip(ms, chain_src))
            # every pool feeds only the chain and this concat
            clean = pool_only and all(
                {id(c) for c in consumers.get(m.outputs[0], [])}
                <= {id(node)} | {id(x) for x in ms if x is not None}
                for m in ms)
            # the conv's bias is in units of the concat's scale, the
            # kernel takes the source's: all scales must agree
            scales_eq = pool_only and all(
                abs(tensors[i].quant.scale - tensors[ins[0]].quant.scale)
                < 1e-12 for i in list(ins) + [out])
            if pool_only and clean and scales_eq:
                plan.sppf[out] = (ins[0], k0[0])
                for m, src_nm in zip(ms, chain_src):
                    plan.skip_outputs.add(m.outputs[0])
                    plan.pool_of[m.outputs[0]] = (src_nm, k0[0])

    # bottlenecks: 1x1 -> KxK/1 (+ planned residual) whose intermediate
    # has exactly one consumer
    for node in nodes:
        if not conv_fold_eligible(node, tensors):
            continue
        m_name = node.outputs[0]
        if m_name in graph_outputs or m_name in plan.stem_stage:
            continue
        a = node.attrs
        if a.get("kernel", (1, 1)) != (1, 1) \
                or a.get("stride", (1, 1)) != (1, 1) \
                or a.get("activation", "NONE") not in _EPILOGUE_ACTS:
            continue
        cons = consumers.get(m_name, [])
        if len(cons) != 1:
            continue
        b = cons[0]
        if (not conv_fold_eligible(b, tensors)
                or b.inputs[0] != m_name
                or b.outputs[0] in plan.stem_stage):
            continue
        ab = b.attrs
        kb = ab.get("kernel", (1, 1))
        if (kb[0] != kb[1] or kb[0] % 2 == 0 or kb[0] < 3
                or ab.get("stride", (1, 1)) != (1, 1)
                or ab.get("activation", "NONE") not in _EPILOGUE_ACTS):
            continue
        x_nm = node.inputs[0]
        t_x, t_m, t_o = tensors[x_nm], tensors[m_name], \
            tensors[b.outputs[0]]
        if not (len(t_x.shape) == 4
                and tuple(t_x.shape[:3]) == tuple(t_m.shape[:3])
                == tuple(t_o.shape[:3])):
            continue
        hh = (kb[0] - 1) // 2
        try:
            pads_a = R._conv_pads(
                (t_x.shape[1], t_x.shape[2]), (t_m.shape[1], t_m.shape[2]),
                (1, 1), (1, 1), a.get("dilation", (1, 1)),
                a["padding"], a["explicit_pad"])
            pads_b = R._conv_pads(
                (t_m.shape[1], t_m.shape[2]), (t_o.shape[1], t_o.shape[2]),
                kb, (1, 1), ab.get("dilation", (1, 1)),
                ab["padding"], ab["explicit_pad"])
        except Exception:
            continue
        if pads_a != ((0, 0), (0, 0)) or pads_b != ((hh, hh), (hh, hh)):
            continue
        f = plan.f(b.outputs[0])
        if plan.f(x_nm) != f or plan.f(m_name) != f:
            continue
        # a planned residual must be the pair's own input (the shortcut)
        ri = plan.res_fuse.get(b.outputs[0])
        if ri is not None and ri[1] != x_nm:
            continue
        plan.bneck[m_name] = (node, b)
