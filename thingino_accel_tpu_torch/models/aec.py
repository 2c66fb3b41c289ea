"""AEC (acoustic echo cancellation) audio model — the second modality.

Port of ``thingino_accel_tpu.models.aec``. The reference ships
``AEC_T41_16K_NS_OUT_UC.mgk`` (27 layers: Conv/GRU/BatchNorm int8) and
runs it host-side via the Venus dlopen path; its decompiler scripts
rebuild it in PyTorch for verification (``mgk-decompiler/scripts/
aec_model.py``, ``aec_inference.py``).

Architecture (from the reference's RE notes, ``mgk-decompiler/
MGK_FORMAT.md``): spectrogram U-Net with a GRU bottleneck — input
[B, 256 freq, 8 frames, 1] -> encoder (1x1 expand + strided freq
downsample to 64 bins, 32 ch) -> GRU over frames (hidden 32, state
streamed across calls) -> decoder (upsample back to 256 bins) -> sigmoid
mask [B, 256, frames, 2].

Two ways to run it, as in JAX:

- :class:`AECModel` over :func:`init_params` (or the GRU weights of a
  `.mgk`, :func:`try_attach_mgk_weights`): :func:`forward` one chunk,
  :func:`process_stream` a long spectrogram chunk by chunk with the GRU
  state carried (JAX's one ``lax.scan``; a loop here);
- :class:`AECStream` and :func:`make_stream_scanner` over the graph the
  `.mgk` decompiler imports (``formats.mgk.import_mgk(path,
  streaming=True)``) on the port's ``Engine`` (the exact tier): one window
  a step, or many streams at once (``torch.func.vmap`` over the streams,
  as JAX's ``jax.vmap``).

Everything runs in float32 with TF32 off on the card
(``ops.reference.no_tf32``). Conv weights are OIHW, activations NCHW
inside :func:`forward` (H the frequency, W the frames); the masks and
states it returns keep JAX's layouts. ``params_from_jax`` converts JAX's
HWIO params. Entry points take ``device="cuda"`` by default and raise
without a card; ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from thingino_accel_tpu_torch.ops.reference import no_tf32
from thingino_accel_tpu_torch.runtime.executor import resolve_device

Device = Union[torch.device, str]


@dataclasses.dataclass
class AECConfig:
    freq_bins: int = 256
    frames: int = 8
    channels: int = 32
    hidden: int = 32
    out_channels: int = 2
    seed: int = 0


def gru_cell(x_t, h, w_ih, w_hh, b_ih, b_hh):
    """Standard GRU cell (torch gate order r, z, n — what the reference's
    PyTorch verification model uses, ``scripts/aec_model.py``), ``x @
    w_ih`` on [C, 3H] weights as JAX's. Not ONNX's z, r, h order
    (``ops.reference.gru``, the graph path's)."""
    hs = h.shape[-1]
    gi = x_t @ w_ih + b_ih
    gh = h @ w_hh + b_hh
    i_r, i_z, i_n = gi[..., :hs], gi[..., hs:2 * hs], gi[..., 2 * hs:]
    h_r, h_z, h_n = gh[..., :hs], gh[..., hs:2 * hs], gh[..., 2 * hs:]
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_scan(x, h0, w_ih, w_hh, b_ih, b_hh, reverse: bool = False):
    """GRU over axis 1 of x [B, T, C] -> ([B, T, H], h_T); ``reverse``
    runs from the last step to the first and keeps each output at its
    step, as ``lax.scan(..., reverse=True)``."""
    t = x.shape[1]
    ys = [None] * t
    h = h0
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        h = gru_cell(x[:, i], h, w_ih, w_hh, b_ih, b_hh)
        ys[i] = h
    return torch.stack(ys, dim=1), h


def init_params_np(cfg: AECConfig) -> Dict[str, np.ndarray]:
    """JAX's ``init_params`` in numpy: the same ``default_rng(cfg.seed)``
    draws in the same order, conv weights HWIO."""
    rng = np.random.default_rng(cfg.seed)
    c, h = cfg.channels, cfg.hidden
    f32 = np.float32

    def w(*shape, fan=None):
        fan = fan or shape[0]
        return rng.normal(0, 1.0 / np.sqrt(fan), shape).astype(f32)

    return {
        "bn_in_scale": np.ones((1,), f32),
        "bn_in_bias": np.zeros((1,), f32),
        "enc_expand_w": w(1, 1, 1, c),          # HWIO 1x1: 1 -> C
        "enc_expand_b": np.zeros((c,), f32),
        "enc_down1_w": w(2, 1, c, c, fan=2 * c),
        "enc_down1_b": np.zeros((c,), f32),
        "enc_conv1_w": w(1, 1, c, c, fan=c),
        "enc_conv1_b": np.zeros((c,), f32),
        "enc_down2_w": w(2, 1, c, c, fan=2 * c),
        "enc_down2_b": np.zeros((c,), f32),
        "enc_conv2_w": w(1, 1, c, c, fan=c),
        "enc_conv2_b": np.zeros((c,), f32),
        "bn_pre_scale": np.ones((c,), f32),
        "bn_pre_bias": np.zeros((c,), f32),
        "gru1_w_ih": w(c, 3 * h, fan=c),
        "gru1_w_hh": w(h, 3 * h, fan=h),
        "gru1_b_ih": np.zeros((3 * h,), f32),
        "gru1_b_hh": np.zeros((3 * h,), f32),
        "gru2f_w_ih": w(h, 3 * h, fan=h),
        "gru2f_w_hh": w(h, 3 * h, fan=h),
        "gru2f_b_ih": np.zeros((3 * h,), f32),
        "gru2f_b_hh": np.zeros((3 * h,), f32),
        "gru2b_w_ih": w(h, 3 * h, fan=h),
        "gru2b_w_hh": w(h, 3 * h, fan=h),
        "gru2b_b_ih": np.zeros((3 * h,), f32),
        "gru2b_b_hh": np.zeros((3 * h,), f32),
        "dec_conv1_w": w(1, 1, 2 * h, c, fan=2 * h),
        "dec_conv1_b": np.zeros((c,), f32),
        "dec_up1_w": w(2, 1, c, c, fan=2 * c),     # freq x2 via repeat+conv
        "dec_up1_b": np.zeros((c,), f32),
        "dec_up2_w": w(2, 1, c, c, fan=2 * c),
        "dec_up2_b": np.zeros((c,), f32),
        "dec_out_w": w(1, 1, c, cfg.out_channels, fan=c),
        "dec_out_b": np.zeros((cfg.out_channels,), f32),
    }


def params_from_jax(params: Dict[str, np.ndarray], device: Device = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """JAX's AEC params (numpy, or anything ``np.asarray`` takes) as the
    port's: float32 tensors on ``device``, each 4-D conv weight HWIO ->
    OIHW, the rest (GRU weights [in, 3H], biases, BN) as they are."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        a = np.array(v, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def init_params(cfg: AECConfig, device: Device = "cuda"
                ) -> Dict[str, torch.Tensor]:
    """JAX's ``init_params(cfg)`` (the same draws) in the port's layout on
    ``device``."""
    return params_from_jax(init_params_np(cfg), device)


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one axis: out = ceil(n / s), the total
    pad split with its smaller half first."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, stride=(1, 1)):
    """NCHW ``x`` by OIHW ``w``, padded by XLA's ``SAME`` rule (explicit,
    since torch refuses ``padding="same"`` at stride 2), + b."""
    (pt, pb), (pl, pr) = (_same_pads(x.shape[2], w.shape[2], stride[0]),
                          _same_pads(x.shape[3], w.shape[3], stride[1]))
    out = F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, None, stride)
    return out + b[None, :, None, None]


def init_state(cfg: AECConfig, batch: int = 1, device: Device = "cuda"
               ) -> torch.Tensor:
    """Streaming GRU hidden state (the reference's persistent
    [64,1,1,32] hidden tensor -> [B, freq_bins/4, hidden] here)."""
    return torch.zeros((batch, cfg.freq_bins // 4, cfg.hidden),
                       dtype=torch.float32, device=resolve_device(device))


def forward(
    params: Dict[str, torch.Tensor],
    spec: torch.Tensor,                  # [B, 256, T, 1] f32 spectrogram
    state: Optional[torch.Tensor] = None,
    cfg: AECConfig = AECConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming step: spectrogram frames -> sigmoid mask [B, 256, T,
    2] + new state [B, 64, hidden], on the params' device.

    The GRU runs per frequency bin over the time axis; ``state`` is
    carried across calls (streaming)."""
    b, fbins, t, _ = spec.shape
    p = params
    relu = torch.relu
    if state is None:
        state = init_state(cfg, b, spec.device)
    with no_tf32():
        x = spec * p["bn_in_scale"] + p["bn_in_bias"]
        x = x.permute(0, 3, 1, 2)                              # NCHW
        x = relu(_conv(x, p["enc_expand_w"], p["enc_expand_b"]))
        x = relu(_conv(x, p["enc_down1_w"], p["enc_down1_b"],
                       stride=(2, 1)))                         # 128 bins
        x = relu(_conv(x, p["enc_conv1_w"], p["enc_conv1_b"]))
        x = relu(_conv(x, p["enc_down2_w"], p["enc_down2_b"],
                       stride=(2, 1)))                         # 64 bins
        skip = relu(_conv(x, p["enc_conv2_w"], p["enc_conv2_b"]))
        x = (skip * p["bn_pre_scale"][:, None, None]
             + p["bn_pre_bias"][:, None, None])

        # GRU over time, one row a frequency bin: [B, C, F, T] -> rows
        bq = x.shape[2]
        xg = x.permute(0, 2, 3, 1).reshape(b * bq, t, cfg.channels)
        h0 = state.reshape(b * bq, cfg.hidden)
        y1, h1 = gru_scan(xg, h0, p["gru1_w_ih"], p["gru1_w_hh"],
                          p["gru1_b_ih"], p["gru1_b_hh"])
        # bidirectional second GRU (bottleneck)
        z0 = torch.zeros_like(h0)
        yf, _ = gru_scan(y1, z0, p["gru2f_w_ih"], p["gru2f_w_hh"],
                         p["gru2f_b_ih"], p["gru2f_b_hh"])
        yb, _ = gru_scan(y1, z0, p["gru2b_w_ih"], p["gru2b_w_hh"],
                         p["gru2b_b_ih"], p["gru2b_b_hh"], reverse=True)
        y = torch.cat([yf, yb], dim=-1)
        y = y.reshape(b, bq, t, 2 * cfg.hidden).permute(0, 3, 1, 2)

        y = relu(_conv(y, p["dec_conv1_w"], p["dec_conv1_b"]))
        y = y + skip                                           # U-Net skip
        y = y.repeat_interleave(2, dim=2)                      # 128 bins
        y = relu(_conv(y, p["dec_up1_w"], p["dec_up1_b"]))
        y = y.repeat_interleave(2, dim=2)                      # 256 bins
        y = relu(_conv(y, p["dec_up2_w"], p["dec_up2_b"]))
        mask = torch.sigmoid(_conv(y, p["dec_out_w"], p["dec_out_b"]))
    new_state = h1.reshape(b, bq, cfg.hidden)
    return mask.permute(0, 2, 3, 1), new_state


def process_stream(
    params: Dict[str, torch.Tensor],
    spec_frames: torch.Tensor,           # [B, 256, total_T, 1]
    chunk: int = 8,
    cfg: AECConfig = AECConfig(),
) -> torch.Tensor:
    """Streamed inference over a long spectrogram in ``chunk``-frame hops
    with carried GRU state -> masks [B, 256, n * chunk, 2] (JAX's one
    outer ``lax.scan``; a loop over the chunks here, each step the
    :func:`forward` of one chunk)."""
    b, fbins, total_t, c = spec_frames.shape
    n = total_t // chunk
    state = init_state(cfg, b, spec_frames.device)
    masks = []
    for i in range(n):
        mask, state = forward(params, spec_frames[:, :, i * chunk:
                                                  (i + 1) * chunk],
                              state, cfg)
        masks.append(mask)
    if masks:
        return torch.cat(masks, dim=2)
    return spec_frames.new_zeros((b, fbins, 0, cfg.out_channels))


def _check_stream_io(graph) -> Tuple[str, str, str, str]:
    """The streaming graph's (input, h0 input, mask output, Y_h output)
    names; ValueError where one is missing."""
    h_in = next((i for i in graph.inputs if "h0" in i), None)
    outs = list(graph.outputs)
    mask_out = "output" if "output" in outs else None
    h_out = next((o for o in outs if "Y_h" in o), None)
    if None in (h_in, mask_out, h_out):
        raise ValueError(
            "streaming AEC graph must expose 'h0' input, 'output' "
            f"and 'Y_h' outputs (got inputs={graph.inputs}, "
            f"outputs={outs}) — import with streaming=True")
    return graph.inputs[0], h_in, mask_out, h_out


def make_stream_scanner(graph, device: Device = "cuda"
                        ) -> Callable[..., torch.Tensor]:
    """Many-stream runner for the DECOMPILED streaming graph
    (``formats.mgk.import_mgk(streaming=True)``) on the port's ``Engine``
    (exact tier, on ``device``).

    Returns ``run(h0 [S,1,64,32], windows [W,S,1,256,8]) -> masks
    [W,S,1,256,2]`` on the device: the graph's forward for one window
    ``torch.func.vmap``-ed over the stream axis (one launch an op for all
    S streams, as JAX's ``jax.vmap``), a loop over the W windows carrying
    gru1's hidden state (JAX's ``lax.scan``). The decompiled graph is one
    stream: its [1, 64, 32] state is frequency groups, not a batch axis.
    Matches :class:`AECStream.run` window for window."""
    from thingino_accel_tpu_torch.runtime.engine import Engine

    eng = Engine(graph, device=device)
    body, params = eng._fn, eng.params
    in_name, h_in, mask_out, h_out = _check_stream_io(graph)

    def step(x, h):
        out = body(params, {in_name: x, h_in: h})
        return out[mask_out], out[h_out]

    vstep = torch.func.vmap(step)

    def run(h0, windows) -> torch.Tensor:
        h = torch.as_tensor(h0, dtype=torch.float32).to(eng.device)
        wins = torch.as_tensor(windows, dtype=torch.float32).to(eng.device)
        masks = []
        with no_tf32(), torch.no_grad():
            for w in range(wins.shape[0]):
                m, h = vstep(wins[w], h)
                masks.append(m)
        return torch.stack(masks)

    return run


def try_attach_mgk_weights(
    params: Dict[str, torch.Tensor], weights_blob: bytes
) -> Dict[str, torch.Tensor]:
    """Attach GRU weights extracted from the `.mgk` blob at the offsets
    documented by the reference's RE (``MGK_FORMAT.md``: unidirectional
    GRU at 0x220c0, bidirectional at 0x0), on the params' device. Conv
    regions need per-layer attribution work; until then they keep their
    init values. int8 blocks are dequantized with a nominal scale."""
    from thingino_accel_tpu_torch.formats.mgk import (
        AEC_WEIGHT_OFFSETS, unpack_gru_blocks,
    )
    out = dict(params)
    scale = np.float32(1.0 / 64.0)

    def fit(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        shape = like.shape
        tiled = np.tile(arr, (max(1, -(-shape[0] // arr.shape[0])),
                              max(1, -(-shape[1] // arr.shape[1]))))
        return torch.from_numpy(np.ascontiguousarray(
            tiled[:shape[0], :shape[1]])).to(like.device)

    off, size = AEC_WEIGHT_OFFSETS["layer_37_gru"]
    if len(weights_blob) >= off + size:
        uni = unpack_gru_blocks(weights_blob[off:off + size], False)
        w_ih = uni["w_ih"].astype(np.float32) * scale      # [64, 32]
        w_hh = uni["w_hh"].astype(np.float32) * scale
        out["gru1_w_ih"] = fit(w_ih, out["gru1_w_ih"])
        out["gru1_w_hh"] = fit(w_hh, out["gru1_w_hh"])

    off, size = AEC_WEIGHT_OFFSETS["layer_46_gru_bidir"]
    if len(weights_blob) >= off + size:
        bi = unpack_gru_blocks(weights_blob[off:off + size], True)
        for d, pfx in (("fwd", "gru2f"), ("bwd", "gru2b")):
            w_i = np.concatenate(
                [bi[f"{d}_w_ir"], bi[f"{d}_w_iz"], bi[f"{d}_w_in"]],
                axis=1).astype(np.float32) * scale        # [32, 96]
            w_h = np.concatenate(
                [bi[f"{d}_w_hr"], bi[f"{d}_w_hz"], bi[f"{d}_w_hn"]],
                axis=1).astype(np.float32) * scale
            out[f"{pfx}_w_ih"] = fit(w_i, out[f"{pfx}_w_ih"])
            out[f"{pfx}_w_hh"] = fit(w_h, out[f"{pfx}_w_hh"])
    return out


def build_aec_graph(weights_blob: bytes = b"", device: Device = "cuda"
                    ) -> "AECModel":
    """`.mgk` import entry: returns a callable model object on ``device``
    (not a layer IR graph — the GRU's carry doesn't fit the flat tensor
    IR; this mirrors how the reference treats .mgk models as opaque
    executables, minus executing their code)."""
    cfg = AECConfig()
    params = init_params(cfg, device)
    if weights_blob:
        params = try_attach_mgk_weights(params, weights_blob)
    return AECModel(cfg, params)


class AECModel:
    """Engine-like wrapper: the streaming forward with state, on the
    device its params are on."""

    def __init__(self, cfg: AECConfig, params: Dict[str, torch.Tensor]):
        self.cfg = cfg
        self.params = params
        self.device = next(iter(params.values())).device

    def run(self, spec, state=None):
        """One chunk ([B, 256, T] or [B, 256, T, 1], numpy or a tensor)
        -> (mask [B, 256, T, 2], new state), tensors on the device (JAX's
        returns the mask as numpy)."""
        spec = torch.as_tensor(spec, dtype=torch.float32).to(self.device)
        if spec.dim() == 3:
            spec = spec[..., None]
        if state is None:
            state = init_state(self.cfg, spec.shape[0], self.device)
        with torch.no_grad():
            return forward(self.params, spec, state, self.cfg)

    # engine-compat introspection used by api.Model
    @property
    def graph(self):
        raise AttributeError("AEC .mgk models use the streaming API")


class AECStream:
    """Streaming wrapper over the DECOMPILED `.mgk` graph (real weights,
    ``formats.mgk.import_mgk(streaming=True)``) on the port's ``Engine``
    (exact tier, on ``device``).

    Carries gru1's hidden state across 8-frame windows — the recurrence
    the reference streams in ``scripts/aec_inference.py`` (its
    ``[64,1,1,32]`` hidden state); gru2 is bidirectional within the
    window and resets per step, matching the reference's behavior.
    Each ``run`` consumes one [B, 256, 8] log1p-magnitude window and
    returns the [B, 256, 2] sigmoid mask for the window's last frame.
    """

    def __init__(self, graph, device: Device = "cuda"):
        from thingino_accel_tpu_torch.runtime.engine import Engine
        self._in, self._h_in, self._mask_out, self._h_out = \
            _check_stream_io(graph)
        self.graph = graph
        self.engine = Engine(graph, device=device)
        self.device = self.engine.device

    def init_state(self) -> torch.Tensor:
        shape = self.graph.tensors[self._h_in].shape
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def run(self, window, state=None):
        """(mask, new state), tensors on the device (JAX's returns the
        mask as numpy)."""
        if state is None:
            state = self.init_state()
        with no_tf32():
            out = self.engine.run(**{self._in: window, self._h_in: state})
        return out[self._mask_out], out[self._h_out]
