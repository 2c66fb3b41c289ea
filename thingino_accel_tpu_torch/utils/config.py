"""Central configuration registry.

Port of ``thingino_accel_tpu.utils.config``: per-engine knobs are
``EngineOptions``; this registry holds the process-level defaults that
some module of the port reads from the environment. All variables are
prefixed ``TAT_``. An unset variable gives its default, and so does a
value its parser refuses.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, tuple] = {}


def _register(name: str, default: Any, parse: Callable[[str], Any],
              doc: str) -> None:
    _REGISTRY[name] = (default, parse, doc)


def get(name: str) -> Any:
    default, parse, _ = _REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return parse(raw)
    except (TypeError, ValueError):
        return default


def describe() -> str:
    lines = ["thingino-accel-tpu environment configuration:"]
    for name, (default, _, doc) in sorted(_REGISTRY.items()):
        cur = get(name)
        mark = "*" if cur != default else " "
        lines.append(f" {mark} {name:<22} = {cur!r:<12} {doc}")
    return "\n".join(lines)


_bool = lambda s: s.strip().lower() not in (
    "0", "false", "no", "off", "")

_register("TAT_LOG", "warn", str, "log level: debug|info|warn|error "
          "(utils.logging)")
_register("TAT_CONV_MERGE", False, _bool,
          "fast tier: merge sibling convs over the same input into one "
          "wider conv + SPLIT (exact; ir.passes.merge_sibling_convs); read "
          "where EngineOptions.conv_merge is None")
_register("TAT_FPN_SPLIT", "wide", str,
          "fast tier: split 1x1 convs over channel concats into per-part "
          "convs (ir.passes.split_concat_convs). 'upsample' (or any other "
          "true value, such as '1') = concats with an upsampled part, "
          "computed at the low resolution; 'wide' = those plus concats "
          "whose every part has >= 128 channels; 'all' = every "
          "1x1-over-concat; '' = off. Read where EngineOptions.fpn_split "
          "is None")
_register("TAT_S2D_DEEP", False, _bool,
          "fast paths over an s2d graph (trace_path.fast_graph): fold one "
          "stage deeper (the stem emits 2x2 space-to-depth layout, the "
          "3x3 s2 downsample becomes 2x2 s1 at 4x the contraction width; "
          "exact; ir.passes.fold_stage2_downsample)")
_register("TAT_FAST_SILU", False, _bool,
          "serving tier: rational fast-sigmoid SiLU epilogue "
          "(|silu err| < 6e-3); default off — Mosaic's exp sigmoid "
          "measured faster on v5e")
_register("TAT_SILU_TANH", False, _bool,
          "fast tier: tanh-form sigmoid in f32/bf16 SiLU "
          "(no divide in the conv+SiLU fusion)")
_register("TAT_SERVING_COMPUTE", "int8", str,
          "serving-tier MXU compute dtype: int8 (exact int32 MACs) | "
          "bf16 (int8 HBM I/O, in-VMEM cast, f32 accumulation — "
          "exact while K*K*C <= 1024)")
_register("TAT_STEM_NOGROW", False, _bool,
          "serving tier: limit the XLA stem stage to the thin-channel "
          "seed convs (cin < 16); the convs it would grow into run on "
          "the folded pallas path instead, so the stage-exit f32 "
          "accumulator read+quantize happens once, on the stem output")
