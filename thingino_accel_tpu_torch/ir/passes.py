"""Graph passes the port runs, copied from ``thingino_accel_tpu/ir/passes.py``.

- ``fuse_silu_pairs``: SIGMOID(x) + MUL(x, sig) -> SILU_FUSED (x*σ(x) in
  one f32 expression with a single requant).
- ``fuse_act_into_conv``: a standalone activation folded into the conv
  before it (the serving tier's epilogue).
- ``fold_batchnorm``: BATCHNORM following CONV2D folded into conv weights
  (f32 graphs).
- ``dead_code``: drop nodes whose outputs are never consumed.
- The fast tier's rewrites: ``dequantize_graph`` (int8 graph -> float
  compute with int8 edges), ``stem_space_to_depth`` (the stride-2 stem
  as a stride-1 conv over 2x2 blocks), ``fold_stage2_downsample`` (the
  fold one stage deeper, behind ``TAT_S2D_DEEP``), ``split_concat_convs``
  and ``merge_sibling_convs`` (1x1 convs over concats split by part,
  sibling convs merged into one).
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
        outputs=list(graph.outputs), name=graph.name,
        stem_s2d=graph.stem_s2d)
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


# ---------------------------------------------------------------------------
# The fast tier's rewrites (float graphs)
# ---------------------------------------------------------------------------


def dequantize_graph(graph: Graph, quantize_outputs: bool = True) -> Graph:
    """An int8 graph lowered to float compute with int8 I/O at its edges
    (the fast tier): int8 conv weights become ``w * w_scale`` (per output
    channel where the file has per-channel scales), int32 biases ``b *
    (in_scale * w_scale)``, int8 activations float32, a DEQUANT after each
    int8 input and, with ``quantize_outputs``, a QUANT before each int8
    output. The numpy f32 arithmetic is the JAX pass's, in its order, so
    the params equal its bit for bit. A bias shared by convs of different
    input scales is cloned per conv. Returns a new graph; the source's
    constants are not written."""
    tensors: Dict[str, TensorInfo] = {}
    nodes: List[Node] = []

    def is_i8(t: TensorInfo) -> bool:
        return (np.issubdtype(t.dtype, np.signedinteger)
                and t.dtype.itemsize == 1)

    def w_scale(wt: TensorInfo):
        return (np.asarray(wt.channel_scales, np.float32)
                if wt.channel_scales is not None
                else np.float32(wt.quant.scale))

    conv_ws: Dict[str, str] = {}   # weight name -> owning conv input name
    conv_bias: Dict[str, tuple] = {}
    bias_rename: Dict[int, str] = {}   # id(node) -> cloned bias name
    for node in graph.nodes:
        if node.op in ("CONV2D", "DEPTHWISE_CONV2D", "FC") \
                and len(node.inputs) >= 2:
            conv_ws[node.inputs[1]] = node.inputs[0]
            if len(node.inputs) >= 3:
                b = node.inputs[2]
                key = (node.inputs[0], node.inputs[1])
                if b not in conv_bias:
                    conv_bias[b] = key
                elif conv_bias[b] != key:
                    nb = f"{b}__dqclone{len(bias_rename)}"
                    bias_rename[id(node)] = nb
                    conv_bias[nb] = key

    for name, t in graph.tensors.items():
        nt = TensorInfo(name=t.name, shape=t.shape, dtype=t.dtype,
                        quant=t.quant, data=t.data,
                        source_format=t.source_format)
        if t.is_const:
            if name in conv_ws and np.issubdtype(t.data.dtype,
                                                 np.signedinteger):
                if t.channel_scales is not None:
                    sc = np.asarray(t.channel_scales, np.float32)
                    bshape = (-1,) + (1,) * (t.data.ndim - 1)
                    nt.data = t.data.astype(np.float32) * sc.reshape(bshape)
                else:
                    nt.data = (t.data.astype(np.float32)
                               * np.float32(t.quant.scale))
                nt.dtype = nt.data.dtype
            elif name in conv_bias and np.issubdtype(
                    t.data.dtype, np.signedinteger) \
                    and t.data.dtype.itemsize >= 4:
                x_name, w_name = conv_bias[name]
                xs = graph.tensors[x_name].quant.scale
                nt.data = (t.data.astype(np.float32)
                           * (np.float32(xs) * w_scale(graph.tensors[w_name])))
                nt.dtype = nt.data.dtype
        elif is_i8(t) and name not in graph.inputs:
            nt.dtype = np.dtype(np.float32)
        tensors[name] = nt

    for nm, (x_name, w_name) in conv_bias.items():
        if nm in tensors or "__dqclone" not in nm:
            continue
        t = graph.tensors[nm.split("__dqclone")[0]]
        xs = graph.tensors[x_name].quant.scale
        data = t.data.astype(np.float32) * (
            np.float32(xs) * w_scale(graph.tensors[w_name]))
        tensors[nm] = TensorInfo(name=nm, shape=t.shape, dtype=data.dtype,
                                 data=data)

    input_map: Dict[str, str] = {}
    for name in graph.inputs:
        t = graph.tensors[name]
        if is_i8(t):
            deq = f"{name}__deq"
            tensors[deq] = TensorInfo(name=deq, shape=t.shape,
                                      dtype=np.dtype(np.float32))
            nodes.append(Node(op="DEQUANT", inputs=[name], outputs=[deq],
                              attrs=dict(scale=t.quant.scale),
                              name=f"deq_{name}"))
            input_map[name] = deq

    for node in graph.nodes:
        ins = [input_map.get(i, i) for i in node.inputs]
        if id(node) in bias_rename:
            ins[2] = bias_rename[id(node)]
        nodes.append(Node(op=node.op, inputs=ins, outputs=list(node.outputs),
                          attrs=dict(node.attrs), name=node.name))

    outputs = []
    for name in graph.outputs:
        t = graph.tensors[name]
        if is_i8(t) and quantize_outputs:
            qn = f"{name}__q"
            tensors[qn] = TensorInfo(name=qn, shape=t.shape, dtype=t.dtype,
                                     quant=t.quant)
            nodes.append(Node(op="QUANT", inputs=[name], outputs=[qn],
                              attrs=dict(scale=t.quant.scale),
                              name=f"q_{name}"))
            outputs.append(qn)
        else:
            outputs.append(name)

    g = Graph(nodes=nodes, tensors=tensors, inputs=list(graph.inputs),
              outputs=outputs, name=f"{graph.name}_deq",
              stem_s2d=graph.stem_s2d)
    g.validate()
    return g


def stem_space_to_depth(graph: Graph) -> bool:
    """Rewrite the stride-2 thin-channel stem conv into its space-to-depth
    form: input ``[B, H, W, C]`` + conv ``KxK s2`` becomes input ``[B, H/2,
    W/2, 4C]`` (2x2 pixel blocks flattened into channels, row-major:
    channel ``(p*2+q)*C + c``) + conv ``(K/2)x(K/2) s1`` with the weights
    gathered by block. Every output sums the same products. The caller
    then feeds frames in that order (``models.yolo.space_to_depth_frames``
    on the host, ``space_to_depth`` on the device).

    Eligible: exactly the first conv over a graph input that is its only
    consumer, K = 2 (mod 4) square, stride 2, C < 16, even H and W, one
    group, no dilation, SAME or the explicit pad (K-2)/2 on every side.
    Rewrites the graph's records in place and marks it (``stem_s2d``);
    returns whether it did."""
    in_names = set(graph.inputs)
    cons = graph.consumers()
    for node in graph.nodes:
        if node.op != "CONV2D" or node.inputs[0] not in in_names:
            continue
        if any(c is not node for c in cons.get(node.inputs[0], [])):
            continue
        in_t = graph.tensors[node.inputs[0]]
        if len(in_t.shape) != 4:
            continue
        b, h, w, c = in_t.shape
        kh, kw = node.attrs.get("kernel", (0, 0))
        # the per-side pad (K-2)/2 must be even to fall on block edges
        if (node.attrs.get("stride") != (2, 2) or kh != kw
                or kh % 4 != 2 or c >= 16 or h % 2 or w % 2
                or node.attrs.get("groups", 1) != 1
                or node.attrs.get("dilation", (1, 1)) != (1, 1)):
            continue
        ep = node.attrs.get("explicit_pad")
        if ep is not None and tuple(ep) != ((kh - 2) // 2,) * 4:
            continue
        wt = graph.tensors[node.inputs[1]]
        o, ci, _, _ = wt.shape            # OIHW
        assert ci == c, (wt.shape, in_t.shape)
        kb = kh // 2
        # tap (2i+p, 2j+q) of channel ch -> tap (i, j) of (p*2+q)*C+ch
        wd = wt.data.reshape(o, c, kb, 2, kb, 2)
        wd = wd.transpose(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, kb, kb)
        wt.data = np.ascontiguousarray(wd)
        wt.shape = tuple(wd.shape)
        node.attrs["kernel"] = (kb, kb)
        node.attrs["stride"] = (1, 1)
        if ep is not None:
            node.attrs["explicit_pad"] = ((kb - 1) // 2,) * 4
        in_t.shape = (b, h // 2, w // 2, 4 * c)
        graph.stem_s2d = True
        return True
    return False


def fold_stage2_downsample(graph: Graph) -> bool:
    """Extend the s2d fold one stage deeper: the stem conv emits its
    output directly in 2x2 space-to-depth layout, and the stage-2 ``3x3
    s2`` downsample conv becomes ``2x2 s1`` over the folded tensor, its
    contraction 4 x C_stem wide instead of C_stem.

    Pattern: ``input -> convA (odd K, s1, SAME) [-> SIGMOID/MUL SiLU
    chain] -> convB (3x3 s2, window from one pixel above and left)``,
    convA's output consumed only by the chain, the chain only by convB,
    no tensor of the chain a graph output. Every output sums the same
    products (the stem places each original tap at one parity position
    of a (K+1)x(K+1) s2 kernel, its out channels parity-major ``(p*2+q) *
    O + o``; the downsample gathers the same 3x3 window from the parity
    channels, taps outside it zero), so the exact tier stays
    bit-identical. Rewrites the graph's records (OIHW weights) in place;
    returns whether it did."""
    cons = graph.consumers()
    in_names = set(graph.inputs)
    for a_node in graph.nodes:
        if (a_node.op != "CONV2D" or a_node.inputs[0] not in in_names
                or a_node.attrs.get("stride") != (1, 1)
                or a_node.attrs.get("groups", 1) != 1
                or a_node.attrs.get("dilation", (1, 1)) != (1, 1)):
            continue
        ka, kaw = a_node.attrs.get("kernel", (0, 0))
        if ka != kaw or ka % 2 != 1:
            continue
        pa = (ka - 1) // 2
        ep = a_node.attrs.get("explicit_pad")
        if (a_node.attrs.get("padding") == "EXPLICIT"
                and ep is not None and tuple(ep) != (pa,) * 4):
            continue
        t_name = a_node.outputs[0]
        t = graph.tensors[t_name]
        if len(t.shape) != 4 or t.shape[1] % 2 or t.shape[2] % 2:
            continue
        # walk the (optional) SiLU chain to the single conv consumer
        chain_tensors: List[str] = []
        cur = t_name
        b_node = None
        while True:
            cs_ = cons.get(cur, [])
            if len(cs_) == 1 and cs_[0].op == "CONV2D":
                b_node = cs_[0]
                break
            if len(cs_) == 2:
                sig = next((n for n in cs_ if n.op == "SIGMOID"), None)
                mul = next((n for n in cs_ if n.op == "MUL"), None)
                if (sig is not None and mul is not None
                        and set(mul.inputs) == {cur, sig.outputs[0]}
                        and cons.get(sig.outputs[0]) == [mul]):
                    chain_tensors += [sig.outputs[0], mul.outputs[0]]
                    cur = mul.outputs[0]
                    continue
            break
        if b_node is None or b_node.inputs[0] != cur:
            continue
        if (b_node.attrs.get("kernel") != (3, 3)
                or b_node.attrs.get("stride") != (2, 2)
                or b_node.attrs.get("groups", 1) != 1
                or b_node.attrs.get("dilation", (1, 1)) != (1, 1)):
            continue
        # convB's (top, left) pads as the runtime resolves them
        # (ops.reference._conv_pads): the rewrite needs the window to start
        # one pixel above and left of the output site; SAME on an even
        # input pads (0, 1) and would shift every value by one pixel
        pad_mode_b = b_node.attrs.get("padding")
        epb = b_node.attrs.get("explicit_pad")
        if pad_mode_b == "EXPLICIT" and epb is not None:
            ptl_b = (epb[0], epb[2])
        elif pad_mode_b == "SAME":
            bt_out = graph.tensors[b_node.outputs[0]]
            oh, ow = bt_out.shape[1], bt_out.shape[2]
            ih, iw = t.shape[1], t.shape[2]
            ptl_b = (max(0, ((oh - 1) * 2 + 3 - ih) // 2),
                     max(0, ((ow - 1) * 2 + 3 - iw) // 2))
        else:
            ptl_b = (0, 0) if pad_mode_b == "VALID" else None
        if ptl_b != (1, 1):
            continue
        # a folded tensor must not escape: its consumers outside the
        # graph would read relaid-out data
        out_set = set(graph.outputs)
        if t_name in out_set or any(nm in out_set for nm in chain_tensors):
            continue

        bb, h, w, ca = t.shape
        wa = graph.tensors[a_node.inputs[1]]
        oa, ci, _, _ = wa.shape              # OIHW
        # stem: tap (ky, kx) at offset (p, q) of a (ka+1)x(ka+1) s2 kernel
        wd = np.zeros((4, oa, ci, ka + 1, ka + 1), wa.data.dtype)
        for p in (0, 1):
            for q in (0, 1):
                wd[p * 2 + q, :, :, p:p + ka, q:q + ka] = wa.data
        wa.data = np.ascontiguousarray(
            wd.reshape(4 * oa, ci, ka + 1, ka + 1))
        wa.shape = wa.data.shape
        if wa.channel_scales is not None:
            wa.channel_scales = np.tile(
                np.asarray(wa.channel_scales), 4)
        if len(a_node.inputs) > 2:
            bt = graph.tensors[a_node.inputs[2]]
            bt.data = np.ascontiguousarray(np.tile(bt.data, 4))
            bt.shape = bt.data.shape
        a_node.attrs["kernel"] = (ka + 1, ka + 1)
        a_node.attrs["stride"] = (2, 2)
        a_node.attrs["padding"] = "EXPLICIT"
        a_node.attrs["explicit_pad"] = (pa, pa, pa, pa)
        # fold every tensor on the A -> B chain
        for nm in [t_name] + chain_tensors:
            tt = graph.tensors[nm]
            tt.shape = (bb, h // 2, w // 2, 4 * ca)

        wb = graph.tensors[b_node.inputs[1]]
        ob, cb, _, _ = wb.shape
        if cb != ca:
            raise ValueError(f"{b_node.name}: weight {wb.shape} over a "
                             f"{t.shape} input")
        # downsample: tap (ky, kx) of channel c is folded channel
        # (p*2+q)*ca + c at folded tap (ku, kv), ky = 2*ku + p - 1 (kx
        # likewise); positions the 3x3 window never reaches stay zero
        wbd = np.zeros((ob, 4, ca, 2, 2), wb.data.dtype)
        for p in (0, 1):
            for q in (0, 1):
                for ku in (0, 1):
                    for kv in (0, 1):
                        ky, kx = 2 * ku + p - 1, 2 * kv + q - 1
                        if 0 <= ky < 3 and 0 <= kx < 3:
                            wbd[:, p * 2 + q, :, ku, kv] = \
                                wb.data[:, :, ky, kx]
        wb.data = np.ascontiguousarray(wbd.reshape(ob, 4 * ca, 2, 2))
        wb.shape = wb.data.shape
        b_node.attrs["kernel"] = (2, 2)
        b_node.attrs["stride"] = (1, 1)
        b_node.attrs["padding"] = "EXPLICIT"
        b_node.attrs["explicit_pad"] = (1, 0, 1, 0)
        graph.validate()
        return True
    return False


SPLIT_MODES = ("upsample", "wide", "all")


def split_concat_convs(graph: Graph, mode: str = "upsample") -> int:
    """Split 1x1 float convs over channel concats into per-part convs
    summed by ADD: ``conv1x1(concat(p0, p1, ...))`` becomes
    ``act(sum_i conv1x1_i(p_i))``, the weight sliced along its input
    channels, the bias on the first part, so the concat is never built for
    this consumer. A part that is a nearest UPSAMPLE's output is convolved
    at the low resolution and upsampled after (both are pointwise in
    space). Float graphs only (after :func:`dequantize_graph`): the sums
    run in another order.

    ``mode``: ``"upsample"`` rewrites only concats with an upsampled part;
    ``"wide"`` those and concats whose every part has >= 128 channels;
    ``"all"`` every eligible one. Rewrites ``graph`` in place; returns the
    number of convs rewritten."""
    producers: Dict[str, Node] = {}
    for n in graph.nodes:
        for o in n.outputs:
            producers[o] = n

    def is_float(nm: str) -> bool:
        return not np.issubdtype(graph.tensors[nm].dtype, np.signedinteger)

    new_nodes: List[Node] = []
    n_rewritten = 0
    uid = 0
    for node in graph.nodes:
        a = node.attrs
        ok = (node.op == "CONV2D"
              and a.get("kernel") == (1, 1)
              and a.get("stride") == (1, 1)
              and a.get("dilation", (1, 1)) == (1, 1)
              and a.get("groups", 1) == 1
              and tuple(a.get("explicit_pad") or (0, 0, 0, 0)) == (0, 0, 0, 0)
              and a.get("activation", "NONE") in (
                  "NONE", "RELU", "SILU", "LEAKY_RELU", "RELU6", "SIGMOID")
              and len(node.inputs) >= 2)
        src = producers.get(node.inputs[0]) if ok else None
        ok = (ok and src is not None and src.op == "CONCAT"
              and src.attrs.get("axis", 3) == 3
              and len(src.inputs) >= 2
              and is_float(node.inputs[0])
              and graph.tensors[node.inputs[1]].is_const
              and is_float(node.inputs[1])
              and all(i in graph.tensors
                      and not graph.tensors[i].is_const
                      and len(graph.tensors[i].shape) == 4
                      for i in src.inputs))
        if ok:
            parts = [graph.tensors[i] for i in src.inputs]
            x_t = graph.tensors[node.inputs[0]]
            ok = (sum(p.shape[3] for p in parts) == x_t.shape[3]
                  and all(p.shape[:3] == x_t.shape[:3] for p in parts)
                  and all(is_float(i) for i in src.inputs)
                  and 0 not in x_t.shape)
        if ok:
            # per part: (input name, the UPSAMPLE's attrs or None)
            plan = []
            any_up = False
            for i in src.inputs:
                p = producers.get(i)
                if (p is not None and p.op == "UPSAMPLE"
                        and p.attrs.get("mode", 0) == 0
                        and is_float(p.inputs[0])):
                    lo = graph.tensors[p.inputs[0]]
                    hi = graph.tensors[i]
                    sc = p.attrs.get("scale", (0, 0))
                    if (sc[0] > 0 and sc[1] > 0
                            and lo.shape[1] * sc[0] == hi.shape[1]
                            and lo.shape[2] * sc[1] == hi.shape[2]):
                        plan.append((p.inputs[0], dict(p.attrs)))
                        any_up = True
                        continue
                plan.append((i, None))
            if mode == "upsample" and not any_up:
                ok = False
            elif mode == "wide" and not any_up and not all(
                    graph.tensors[i].shape[3] >= 128 for i in src.inputs):
                ok = False
        if not ok:
            new_nodes.append(node)
            continue

        out_name = node.outputs[0]
        out_t = graph.tensors[out_name]
        W = graph.tensors[node.inputs[1]].data     # OIHW [O, C, 1, 1]
        o_ch = W.shape[0]
        bias_in = list(node.inputs[2:3])   # on the first part's conv
        act = a.get("activation", "NONE")
        fdt = np.dtype(np.float32)

        def fresh(tag, shape):
            nonlocal uid
            uid += 1
            nm = f"{out_name}__scc{uid}_{tag}"
            graph.tensors[nm] = TensorInfo(name=nm, shape=tuple(shape),
                                           dtype=fdt)
            return nm

        acc = None
        off = 0
        for pi, (src_nm, up_attrs) in enumerate(plan):
            ci = graph.tensors[src.inputs[pi]].shape[3]
            wnm = fresh(f"w{pi}", (o_ch, ci, 1, 1))
            graph.tensors[wnm].data = np.ascontiguousarray(
                W[:, off:off + ci]).astype(W.dtype)
            graph.tensors[wnm].dtype = W.dtype
            off += ci
            st = graph.tensors[src_nm]
            part_out = fresh(f"p{pi}", (st.shape[0], st.shape[1],
                                        st.shape[2], o_ch))
            new_nodes.append(Node(
                op="CONV2D",
                inputs=[src_nm, wnm] + (bias_in if pi == 0 else []),
                outputs=[part_out],
                attrs=dict(kernel=(1, 1), stride=(1, 1), dilation=(1, 1),
                           padding="EXPLICIT", explicit_pad=(0, 0, 0, 0),
                           groups=1, activation="NONE"),
                name=f"{node.name}_scc{pi}"))
            if up_attrs is not None:
                up_out = fresh(f"u{pi}", (st.shape[0],
                                          st.shape[1] * up_attrs["scale"][0],
                                          st.shape[2] * up_attrs["scale"][1],
                                          o_ch))
                new_nodes.append(Node(op="UPSAMPLE", inputs=[part_out],
                                      outputs=[up_out], attrs=up_attrs,
                                      name=f"{node.name}_sccu{pi}"))
                part_out = up_out
            if acc is None:
                acc = part_out
            else:
                tgt = (out_name if (pi == len(plan) - 1 and act == "NONE")
                       else fresh(f"s{pi}", out_t.shape))
                new_nodes.append(Node(op="ADD", inputs=[acc, part_out],
                                      outputs=[tgt],
                                      name=f"{node.name}_scca{pi}"))
                acc = tgt
        if act != "NONE":
            new_nodes.append(Node(
                op=act, inputs=[acc], outputs=[out_name],
                attrs=({"alpha": a.get("alpha")} if act == "LEAKY_RELU"
                       else {}),
                name=f"{node.name}_sccact"))
        n_rewritten += 1

    if n_rewritten:
        graph.nodes = new_nodes
        dead_code(graph)
        graph.validate()
    return n_rewritten


def merge_sibling_convs(graph: Graph) -> int:
    """Merge float convs over the same input with equal hyperparameters
    (kernel, stride, dilation, padding, activation; one group) into one
    conv whose weight and bias are the members' concatenated along the
    output channels, followed by a SPLIT back into the members' outputs.
    Every output channel sums the same products; a wider conv may sum
    them in another order. Float graphs only (after
    :func:`dequantize_graph`). Rewrites ``graph`` in place; returns the
    number of groups merged."""
    def key_of(n: Node):
        a = n.attrs
        if (n.op != "CONV2D" or len(n.outputs) != 1
                or len(n.inputs) not in (2, 3)
                or a.get("groups", 1) != 1):
            return None
        w = graph.tensors.get(n.inputs[1])
        if (w is None or not w.is_const or len(w.shape) != 4
                or np.issubdtype(w.dtype, np.signedinteger)
                or w.channel_scales is not None):
            return None
        if len(n.inputs) == 3:
            b = graph.tensors.get(n.inputs[2])
            if (b is None or not b.is_const
                    or np.issubdtype(b.dtype, np.signedinteger)):
                return None
        out = graph.tensors[n.outputs[0]]
        if np.issubdtype(out.dtype, np.signedinteger):
            return None
        return (n.inputs[0], tuple(a.get("kernel", ())),
                tuple(a.get("stride", ())),
                tuple(a.get("dilation", (1, 1))),
                a.get("padding"),
                tuple(a.get("explicit_pad") or ()),
                a.get("activation", "NONE"), a.get("alpha"))

    groups: Dict[tuple, List[Node]] = {}
    for n in graph.nodes:
        k = key_of(n)
        if k is not None:
            groups.setdefault(k, []).append(n)
    groups = {k: v for k, v in groups.items() if len(v) >= 2}
    if not groups:
        return 0

    first_member = {id(v[0]): k for k, v in groups.items()}
    member_ids = {id(n) for v in groups.values() for n in v}
    new_nodes: List[Node] = []
    n_merged = 0
    for node in graph.nodes:
        if id(node) not in member_ids:
            new_nodes.append(node)
            continue
        k = first_member.get(id(node))
        if k is None:
            continue                       # a later member: emitted
        members = groups[k]
        sizes = [graph.tensors[m.outputs[0]].shape[3] for m in members]
        out0 = graph.tensors[members[0].outputs[0]]
        mnm = f"{members[0].outputs[0]}__msc"
        wnm = f"{mnm}_w"
        W = np.concatenate(
            [np.ascontiguousarray(graph.tensors[m.inputs[1]].data)
             for m in members], axis=0)
        graph.tensors[wnm] = TensorInfo(name=wnm, shape=W.shape,
                                        dtype=W.dtype, data=W)
        ins = [k[0], wnm]
        if any(len(m.inputs) == 3 for m in members):
            bs = []
            for m, sz in zip(members, sizes):
                if len(m.inputs) == 3:
                    bs.append(np.asarray(graph.tensors[m.inputs[2]].data,
                                         np.float32).reshape(-1))
                else:
                    bs.append(np.zeros(sz, np.float32))
            B = np.concatenate(bs)
            bnm = f"{mnm}_b"
            graph.tensors[bnm] = TensorInfo(name=bnm, shape=B.shape,
                                            dtype=B.dtype, data=B)
            ins.append(bnm)
        graph.tensors[mnm] = TensorInfo(
            name=mnm, shape=out0.shape[:3] + (sum(sizes),),
            dtype=out0.dtype)
        new_nodes.append(Node(op="CONV2D", inputs=ins, outputs=[mnm],
                              attrs=dict(members[0].attrs),
                              name=f"{members[0].name}_msc"))
        new_nodes.append(Node(op="SPLIT", inputs=[mnm],
                              outputs=[m.outputs[0] for m in members],
                              attrs=dict(axis=3, sizes=sizes),
                              name=f"{members[0].name}_mscs"))
        n_merged += 1

    graph.nodes = new_nodes
    graph.validate()
    return n_merged
