"""``thingino_accel_tpu_torch.trace_path``, the card's busy/idle profile:
the interval union it reads the busy time from, and its refusal to run
without a card (it never measures on the CPU)."""

import pytest
import torch

from thingino_accel_tpu_torch import trace_path as T


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 2), (1, 3), (5, 6), (5.5, 5.7)], 4.0),
    ([(4, 5), (0, 10)], 10.0),
    ([(0, 1), (1, 2)], 2.0),
])
def test_union_of_device_intervals(intervals, want):
    assert T._union_us(intervals) == want


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the trace would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.trace("exact_yolov5s", batches=1, batch=1)
