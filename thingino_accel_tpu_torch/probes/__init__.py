"""Ports of the JAX package's TPU probes under ``examples/``, each a module
that runs as ``python3 -m thingino_accel_tpu_torch.probes.<name>`` and
prints its table, on the card unless ``--device cpu`` is given:

- ``mxu_ceiling`` (E1): chained tensor-core products, int8 against bf16;
- ``megakernel`` (E3): the requantize epilogue, the 3x3 taps and the C3
  round at that ceiling;
- ``wedge`` (E4): the device health ladder;
- ``pipeline`` (E2): the 3x3 conv's epilogue lagged a tile behind its
  tensor-core product, against the same kernel unlagged, #2 and #5.

Their kernels are in ``ops.probe_kernels``; ``timing`` is the chained,
baseline-subtracted timing both rate probes use.
"""
