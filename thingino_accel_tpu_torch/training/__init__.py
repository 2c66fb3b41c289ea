"""Training-side tools of the port: post-training quantization
(``ptq``) and quantization-aware training (``qat``, on
``torch.autograd``)."""

from thingino_accel_tpu_torch.training.qat import (
    fake_quant, make_train_step, export_int8,
)

__all__ = ["fake_quant", "make_train_step", "export_int8"]
