"""Sharded forward, QAT train step and detector over a ('dp', 'tp') mesh.

Port of ``thingino_accel_tpu.parallel.shard``. JAX jits the engine's body
with shardings and lets GSPMD insert the collectives; here the port runs
the same lowering (``Executor.lower_node``) on each device of the mesh
and moves the tensors itself, in one process:

- dp: the batch splits over the mesh's rows, each row runs its slice;
  the results are gathered onto the first device along the batch.
- tp: within a row, node by node. A CONV2D, DEPTHWISE_CONV2D or FC whose
  weight is sharded (``mesh.param_sharding_rules``) computes its
  output-channel slice on each tp device, through the executor of a graph
  whose records are those slices (a depthwise conv reads its input's
  channel slice too). Each output such a node produces is all-gathered
  along the last axis (NHWC channels) for each consumer that reads it,
  and for the caller where it is a graph output: JAX's pattern (one
  channel all-gather a sharded producer -> consumer edge, no partial sums
  since O is sharded, not I). Any other node runs on every tp device and
  reads a sharded param gathered.

Every object counts the gathers it makes in ``gathers``: ``"channels"``
(activations, one per edge and dp row) and ``"params"`` (params read
whole).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from thingino_accel_tpu_torch.ir.graph import Graph, Node
from thingino_accel_tpu_torch.parallel.mesh import (
    Mesh, batch_sharding, param_sharding_rules, place, shard_params,
    spec_axis,
)
from thingino_accel_tpu_torch.runtime.executor import (
    Executor, _torch_dtype, build_executor, is_depthwise, prepare_params,
)

# the ops whose output channels follow their weight's tp shard
SHARDED_OPS = ("CONV2D", "DEPTHWISE_CONV2D", "FC")


def _on(dev: torch.device):
    """``dev`` as the current CUDA device (a kernel launches on the current
    device); nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _gather(pieces: Sequence[torch.Tensor], axis: int, dev: torch.device
            ) -> torch.Tensor:
    return torch.cat([p.to(dev) for p in pieces], dim=axis)


def _new_gathers() -> Dict[str, int]:
    return {"channels": 0, "params": 0}


def _split_batch(inputs: Dict[str, object], graph: Graph, mesh: Mesh
                 ) -> List[Dict[str, torch.Tensor]]:
    """The graph inputs as tensors of the graph's dtypes, split along the
    batch over dp: row ``i``'s slice of each, on device ``(i, 0)``."""
    column = _column(mesh)
    rows: List[Dict[str, torch.Tensor]] = [{} for _ in range(
        mesh.shape["dp"])]
    for name in graph.inputs:
        if name not in inputs:
            raise ValueError(f"missing input {name!r}")
        x = torch.as_tensor(inputs[name]).to(
            _torch_dtype(graph.tensors[name].dtype))
        for i, row in enumerate(place(x, batch_sharding(column), column)):
            rows[i][name] = row[0]
    return rows


def _column(mesh: Mesh) -> Mesh:
    """The mesh's first column: one device a dp row."""
    return Mesh(mesh.devices[:, :1])


class TpLowering:
    """The node-by-node tp lowering of ``graph`` over the rows of ``mesh``.

    ``build(graph, device)`` gives an unplanned executor of the tier, made
    once (:func:`_cached`); ``rules``: the params' specs. Each tp rank
    ``j`` has the graph of its slices (:meth:`_shard_graph`: the sharded
    nodes' weights, biases, per-channel scales and outputs, a depthwise
    conv's input and groups, cut to slice ``j``), and an executor of it on
    each device it runs on."""

    def __init__(self, graph: Graph, rules: Dict[str, tuple], mesh: Mesh,
                 build: Callable[[Graph, torch.device], Executor],
                 gathers: Dict[str, int]):
        self.graph, self.rules, self.mesh = graph, rules, mesh
        self.build, self.gathers = build, gathers
        main = self.executor(None, mesh.devices[0, 0])
        self.nodes: List[Node] = main.nodes
        tp = mesh.shape["tp"]
        self.sharded: Dict[str, Node] = {}
        weights = set()
        for node in self.nodes:
            if node.op in SHARDED_OPS and len(node.inputs) > 1:
                weights.add(node.inputs[1])
                if tp > 1 and self._shardable(node, main):
                    self.sharded[node.outputs[0]] = node
        # weights a tp mesh leaves whole: their O does not divide by tp
        self.whole = sorted(
            w for w in weights if tp > 1
            and w not in {n.inputs[1] for n in self.sharded.values()})
        self.sharded_params = {p for p, s in rules.items() if s}
        self._graphs: List[Graph] = []
        self._shard_nodes: List[Dict[str, Node]] = []
        for j in range(tp if self.sharded else 0):
            g, nodes = self._shard_graph(j)
            self._graphs.append(g)
            self._shard_nodes.append(nodes)

    def executor(self, j: Optional[int], dev: torch.device) -> Executor:
        """The executor of the whole graph (``j`` None) or of tp rank
        ``j``'s slices, on ``dev``."""
        return self.build(self.graph if j is None else self._graphs[j], dev)

    def _shardable(self, node: Node, ex: Executor) -> bool:
        """A node that computes its output-channel slice: its weight sharded
        along the output channel (a conv's OHWI axis 0, a depthwise or FC
        weight's last axis), its bias along its one axis, one group or a
        depthwise conv."""
        w = node.inputs[1]
        axis = spec_axis(self.rules.get(w, ()), "tp")
        if axis is None or ex.degenerate(node):
            return False
        if node.op != "FC" and not is_depthwise(node, ex.tensors) \
                and node.attrs.get("groups", 1) != 1:
            return False
        want = 0 if w in ex.conv_weights else len(self.rules[w]) - 1
        return axis == want and (len(node.inputs) < 3 or self.rules.get(
            node.inputs[2]) == ("tp",))

    def _shard_graph(self, j: int) -> Tuple[Graph, Dict[str, Node]]:
        """Rank ``j``'s graph of slices (its sharded nodes only), and those
        nodes by output name."""
        tp = self.mesh.shape["tp"]
        g = self.graph
        tensors = dict(g.tensors)
        done = set()   # a tensor two sharded nodes share is cut once

        def cut(name: str, axis: int) -> None:
            if name in done:
                return
            done.add(name)
            t = tensors[name]
            n = t.shape[axis] // tp
            rep = {"shape": t.shape[:axis] + (n,) + t.shape[axis + 1:]}
            if t.data is not None:
                rep["data"] = np.take(t.data, range(j * n, (j + 1) * n),
                                      axis=axis)
            if t.channel_scales is not None:
                cs = np.asarray(t.channel_scales)
                if cs.size > 1:
                    rep["channel_scales"] = cs[j * n:(j + 1) * n]
            tensors[name] = dataclasses.replace(t, **rep)

        nodes: Dict[str, Node] = {}
        for out, node in self.sharded.items():
            w = g.tensors[node.inputs[1]]
            attrs = dict(node.attrs)
            if node.op == "FC":
                cut(node.inputs[1], len(w.shape) - 1)
            elif is_depthwise(node, g.tensors):
                # OIHW [O, I, KH, KW] with O * I = C channels
                if node.inputs[1] not in done:
                    t = g.tensors[node.inputs[1]]
                    c = t.shape[0] * t.shape[1]
                    tensors[node.inputs[1]] = dataclasses.replace(
                        t, shape=(c, 1) + t.shape[2:],
                        data=t.data.reshape((c, 1) + t.shape[2:]))
                cut(node.inputs[1], 0)
                cut(node.inputs[0], len(g.tensors[node.inputs[0]].shape) - 1)
                if attrs.get("groups", 1) > 1:
                    attrs["groups"] = attrs["groups"] // tp
            else:
                cut(node.inputs[1], 0)   # OIHW: O
            if len(node.inputs) > 2:
                cut(node.inputs[2], 0)
            cut(out, len(g.tensors[out].shape) - 1)
            nodes[out] = Node(op=node.op, inputs=list(node.inputs),
                              outputs=list(node.outputs), attrs=attrs,
                              name=node.name)
        return Graph(nodes=list(nodes.values()), tensors=tensors, inputs=[],
                     outputs=[], name=f"{g.name}_tp{j}"), nodes

    def row(self, i: int, params: List[Dict[str, torch.Tensor]],
            feeds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Row ``i``'s forward: ``params[j]`` the params on device ``(i, j)``
        (a sharded param's tp shard ``j``, the others whole), ``feeds`` the
        row's inputs. Returns the graph outputs on device ``(i, 0)``."""
        devs = list(self.mesh.devices[i])
        tp = len(devs)
        envs = [dict(params[j]) for j in range(tp)]
        for j, dev in enumerate(devs):
            envs[j].update({k: v.to(dev) for k, v in feeds.items()})
        slices: Dict[str, List[torch.Tensor]] = {}
        for node in self.nodes:
            for name in dict.fromkeys(node.inputs):
                if name in slices:
                    self.gathers["channels"] += 1
                    for j, dev in enumerate(devs):
                        envs[j][name] = _gather(slices[name], -1, dev)
            out = node.outputs[0]
            if out in self.sharded:
                pieces = []
                for j, dev in enumerate(devs):
                    snode = self._shard_nodes[j][out]
                    env = envs[j]
                    over = {}
                    if is_depthwise(node, self.graph.tensors):
                        x = env[node.inputs[0]]
                        c = x.shape[-1] // tp
                        over[node.inputs[0]] = x.narrow(
                            x.dim() - 1, j * c, c).contiguous()
                    self._lower(self.executor(j, dev), snode, env, over, dev)
                    pieces.append(env.pop(out))
                slices[out] = pieces
                continue
            reads = [p for p in dict.fromkeys(node.inputs)
                     if p in self.sharded_params]
            self.gathers["params"] += len(reads)
            for j, dev in enumerate(devs):
                over = {p: _gather([params[k][p] for k in range(tp)],
                                   spec_axis(self.rules[p], "tp"), dev)
                        for p in reads}
                self._lower(self.executor(None, dev), node, envs[j], over,
                            dev)
        out = {}
        for name in self.graph.outputs:
            if name in slices:
                self.gathers["channels"] += 1
                out[name] = _gather(slices[name], -1, devs[0])
            else:
                out[name] = envs[0][name]
        return out

    @staticmethod
    def _lower(ex: Executor, node: Node, env: Dict[str, torch.Tensor],
               over: Dict[str, torch.Tensor], dev: torch.device) -> None:
        """``node`` through ``ex.lower_node`` on ``env`` with the tensors of
        ``over`` in place of env's (outputs written back into ``env``)."""
        local = {**env, **over} if over else env
        with _on(dev):
            ex.lower_node(node, local)
        if over:
            for o in node.outputs:
                env[o] = local[o]


def _cached(build: Callable[[Graph, torch.device], Executor]
            ) -> Callable[[Graph, torch.device], Executor]:
    """``build`` made once a (graph, device)."""
    cache: Dict[tuple, Executor] = {}

    def get(graph: Graph, dev: torch.device) -> Executor:
        key = (id(graph), str(dev))
        if key not in cache:
            cache[key] = build(graph, dev)
        return cache[key]
    return get


def _engine_executors(engine, planned: bool
                      ) -> Callable[[Graph, torch.device], Executor]:
    """Executors of the engine's tier and options on any device, each made
    once (the engine's own where the graph and device are its own)."""
    o = engine.options

    def build(graph: Graph, dev: torch.device) -> Executor:
        if (graph is engine.graph and dev == engine.device
                and planned == engine.planned):
            return engine._fn
        return build_executor(graph, dev, planned, o.precision, o.mode,
                              o.round_mode, o.fuse_silu, o.compute_dtype,
                              o.accum_dtype)
    return _cached(build)


class ShardedForward:
    """``fn(sharded_params, inputs) -> outputs``, :func:`make_sharded_forward`'s.

    ``whole``: the conv, depthwise and FC weights a tp mesh leaves whole
    (their O does not divide by tp); ``gathers``: the gathers made."""

    def __init__(self, engine, mesh: Mesh, rules: Dict[str, tuple]):
        self.engine, self.mesh, self.rules = engine, mesh, rules
        self.gathers = _new_gathers()
        self.planned = engine.planned
        if self.planned:
            self._executor = _engine_executors(engine, True)
            self.whole: List[str] = []
        else:
            self.tp = TpLowering(engine.graph, rules, mesh,
                                 _engine_executors(engine, False),
                                 self.gathers)
            self.whole = self.tp.whole

    def _planned_row(self, i: int, sharded_params, feeds):
        """A planned engine's row: its steps whole on every tp device, the
        sharded weights gathered there; the first device's outputs."""
        devs = list(self.mesh.devices[i])
        outs = None
        for j, dev in enumerate(devs):
            params = {}
            for k, rows in sharded_params.items():
                axis = spec_axis(self.rules[k], "tp")
                if axis is None:
                    params[k] = rows[i][j]
                else:
                    params[k] = _gather(rows[i], axis, dev)
                    if j == 0:
                        self.gathers["params"] += 1
            ex = self._executor(self.engine.graph, dev)
            with _on(dev):
                o = ex(params, {k: v.to(dev) for k, v in feeds.items()})
            outs = o if outs is None else outs
        return outs

    def __call__(self, sharded_params, inputs) -> Dict[str, torch.Tensor]:
        g = self.engine.graph
        rows = []
        for i, feeds in enumerate(_split_batch(inputs, g, self.mesh)):
            if self.planned:
                rows.append(self._planned_row(i, sharded_params, feeds))
            else:
                tp = self.mesh.shape["tp"]
                rows.append(self.tp.row(i, [
                    {k: v[i][j] for k, v in sharded_params.items()}
                    for j in range(tp)], feeds))
        dev0 = self.mesh.devices[0, 0]
        return {k: _gather([r[k] for r in rows], 0, dev0) for k in g.outputs}


def make_sharded_forward(engine, mesh: Mesh
                         ) -> Tuple[ShardedForward, Dict[str, list]]:
    """The engine's forward with the batch over dp and the output channels
    over tp (module docstring). Returns ``(fn, sharded_params)``; call
    ``fn(sharded_params, inputs)`` with inputs whose batch divides by dp.
    The outputs equal the engine's, gathered on the mesh's first device.

    A planned engine (the serving tier's schedule) keeps its steps whole:
    a step fuses several convs into one kernel, and the node-by-node
    lowering is not bit-equal to the planned one, so each tp device runs
    the whole schedule with the weights gathered on it."""
    conv_weights = engine._fn.conv_weights
    rules = param_sharding_rules(engine.params, mesh, conv_weights)
    return (ShardedForward(engine, mesh, rules),
            shard_params(engine.params, mesh, conv_weights))


def make_sharded_train_step(graph: Graph, mesh: Mesh,
                            optimizer: Optional[Callable] = None,
                            qat: bool = True):
    """A QAT train step over the float32 graph in the exact tier, its params
    sharded over tp, its batch over dp (``training.qat.make_train_step``
    around the sharded forward), as JAX's.

    The params are leaves: one a tp shard of a sharded param (on device
    ``(0, j)``), one for a replicated param (on the first device). Each dp
    row reads copies made by differentiable ``.to()``, so autograd sums
    the rows' gradients into the leaves (JAX's psum over dp). The loss
    (``qat.head_l2_loss``) is the whole batch's, over the outputs gathered
    on the first device, as GSPMD computes it. With ``qat``, each float
    weight of 3 or more dimensions is fake-quantized at its whole tensor's
    per-tensor scale (the largest of its shards' absmax), as
    ``qat.fake_quant_params`` on the whole tensor.

    ``optimizer(leaves) -> torch.optim.Optimizer``, Adam at 1e-4 by
    default (JAX's ``optax.adam(1e-4)``). Returns ``(train_step, params,
    opt_state)``: ``params`` maps each name to its leaves, ``opt_state`` is
    the optimizer, and ``train_step(params, opt_state, inputs, targets)``
    returns ``(params, opt_state, loss)``, updating the leaves in place.
    ``train_step.gather(tensors)`` puts each name's shards (the leaves, or
    their ``.grad``) back together on the first device;
    ``train_step.gathers`` counts the gathers."""
    from thingino_accel_tpu_torch.training import qat as Q

    dev0 = mesh.devices[0, 0]
    dp, tp = mesh.devices.shape

    build = _cached(lambda g, dev: build_executor(g, dev, False, "exact",
                                                  "full"))
    main = build(graph, dev0)
    whole = main.device_params({
        k: (v.astype(np.float32) if np.issubdtype(v.dtype, np.floating)
            else v) for k, v in prepare_params(graph).items()})
    rules = param_sharding_rules(whole, mesh, main.conv_weights)
    gathers = _new_gathers()
    lowering = TpLowering(graph, rules, mesh, build, gathers)
    params: Dict[str, List[torch.Tensor]] = {}
    for k, v in whole.items():
        pieces = place(v, rules[k], mesh)[0] if rules[k] else [v]
        params[k] = [p.detach().clone().requires_grad_(
            p.is_floating_point()) for p in pieces]
    opt = (optimizer or (lambda ps: torch.optim.Adam(ps, lr=1e-4)))(
        [p for ps in params.values() for p in ps if p.requires_grad])

    def quantized(name: str, pieces: List[torch.Tensor]
                  ) -> List[torch.Tensor]:
        p = pieces[0]
        if not (qat and p.dim() >= 3 and p.numel()
                and p.is_floating_point()):
            return pieces
        amax = torch.stack([q.abs().max().to(dev0) for q in pieces]).max()
        s = torch.clamp_min(amax / 127.0, 1e-8)
        return [Q.fake_quant(q, s.to(q.device)) for q in pieces]

    def forward(flat, inputs):
        fq = {k: quantized(k, [flat[(k, j)] for j in range(len(v))])
              for k, v in params.items()}
        rows = []
        for i, feeds in enumerate(_split_batch(inputs, graph, mesh)):
            rows.append(lowering.row(i, [
                {k: v[j if len(v) > 1 else 0].to(mesh.devices[i, j])
                 for k, v in fq.items()} for j in range(tp)], feeds))
        return {k: _gather([r[k] for r in rows], 0, dev0)
                for k in graph.outputs}

    step = Q.make_train_step(forward, opt, qat=False)

    def train_step(params, opt_state, inputs, targets):
        flat = {(k, j): p for k, ps in params.items()
                for j, p in enumerate(ps)}
        loss = step(flat, inputs, {k: torch.as_tensor(v).to(dev0)
                                   for k, v in targets.items()})
        return params, opt_state, loss

    def gather(tensors: Dict[str, List[torch.Tensor]]
               ) -> Dict[str, torch.Tensor]:
        return {k: (_gather(v, spec_axis(rules[k], "tp"), dev0)
                    if rules[k] else v[0].to(dev0))
                for k, v in tensors.items()}

    train_step.gather = gather
    train_step.gathers = gathers
    return train_step, params, opt


class ShardedDetector:
    """``fn(sharded_params, frames_u8) -> (boxes, scores, classes, valid)``
    of :func:`make_sharded_detector`; ``gathers`` stays 0."""

    def __init__(self, engine, mesh: Mesh, max_dets: int,
                 conf_thresh: float, iou_thresh: float):
        g = engine.graph
        self.engine, self.mesh = engine, mesh
        self.max_dets, self.conf_thresh = max_dets, conf_thresh
        self.iou_thresh = iou_thresh
        self.gathers = _new_gathers()
        self.in_name = g.inputs[0]
        self.out_names = list(g.outputs)
        in_t = g.tensors[self.in_name]
        self.in_hw = (in_t.shape[1], in_t.shape[2])
        # per-head dequant scale (None for a float head)
        scales = [g.tensors[o].quant.scale
                  if np.issubdtype(g.tensors[o].dtype, np.signedinteger)
                  else None for o in self.out_names]
        self.scales = None if all(s is None for s in scales) else scales
        head_ch = g.tensors[self.out_names[0]].shape[3]
        self.num_classes = head_ch // 3 - 5
        if head_ch != 3 * (5 + self.num_classes):
            raise ValueError(f"head channels {head_ch} are not 3*(5+nc): "
                             "make_sharded_detector expects yolov5-anchor "
                             "heads")
        self._executor = _engine_executors(engine, engine.planned)

    def _shard(self, params, frames_u8: torch.Tensor, dev: torch.device):
        """One dp shard's pipeline on ``dev``."""
        from thingino_accel_tpu_torch.models import yolo
        from thingino_accel_tpu_torch.ops.decode_kernel import (
            decode_and_parse_fused,
        )
        ex = self._executor(self.engine.graph, dev)
        with _on(dev):
            lb = yolo.letterbox_uint8(frames_u8, self.in_hw)
            x = yolo.quantize_input_int8(lb)
            feats = ex(params, {self.in_name: x})
            boxes, conf, cls = decode_and_parse_fused(
                [feats[k] for k in self.out_names], num_classes=
                self.num_classes, scales=self.scales)
            return yolo.nms_batched(
                boxes, conf, cls, conf_thresh=self.conf_thresh,
                iou_thresh=self.iou_thresh, max_dets=self.max_dets)

    def __call__(self, sharded_params, frames_u8):
        column = _column(self.mesh)
        shards = place(torch.as_tensor(frames_u8), batch_sharding(column),
                       column)
        dets = [self._shard({k: v[i][0] for k, v in sharded_params.items()},
                            shards[i][0], self.mesh.devices[i, 0])
                for i in range(len(shards))]
        dev0 = self.mesh.devices[0, 0]
        return tuple(_gather([getattr(d, f) for d in dets], 0, dev0)
                     for f in ("boxes", "scores", "classes", "valid"))


def make_sharded_detector(engine, mesh: Mesh, *, max_dets: int = 100,
                          conf_thresh: float = 0.25,
                          iou_thresh: float = 0.45
                          ) -> Tuple[ShardedDetector, Dict[str, list]]:
    """The detection pipeline (letterbox -> int8 quantize -> network ->
    decode -> NMS) dp-sharded over the mesh: each dp shard runs whole on
    its row's first device, so nothing crosses devices but the frames'
    scatter and the results' gather (``fn.gathers`` stays 0). The weights
    are whole on every device (tp adds nothing here). Returns ``(fn,
    sharded_params)``; ``fn(sharded_params, frames_u8)`` takes [B, H, W, 3]
    uint8 (B divisible by dp) and returns the fixed-shape detections'
    (boxes, scores, classes, valid), gathered on the first device."""
    params = {k: place(v, (), mesh) for k, v in engine.params.items()}
    return (ShardedDetector(engine, mesh, max_dets, conf_thresh, iou_thresh),
            params)
