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


@pytest.mark.parametrize("path,n,distinct", [
    ("planned_yolov5n", 8, 8), ("unplanned_yolov5n", 18, 11),
    ("zoo_yolov5s", 7, 7), ("nanodet", 1, 1)])
def test_kxk_bench_finds_each_paths_kxk_convs(path, n, distinct):
    """``kxk_bench`` times the convs the serving tier sends to #2: as many
    as the path's launches a forward (chip_smoke.py's census), none of
    them a 1x1/s1."""
    from thingino_accel_tpu_torch import kxk_bench as KB
    eng, convs = KB.kxk_convs(path, device="cpu")
    assert len(convs) == n
    for node, ep, _, _ in convs:
        a = node.attrs
        assert a["kernel"] != (1, 1) or a["stride"] != (1, 1)
        assert ep.cs.shape[0] == eng.graph.tensors[node.outputs[0]].shape[3]
    keys = {(tuple(eng.graph.tensors[nd.inputs[0]].shape),
             tuple(nd.attrs["kernel"]), tuple(nd.attrs["stride"]),
             tuple(eng.graph.tensors[nd.outputs[0]].shape), ep.act,
             res is not None) for nd, ep, res, _ in convs}
    assert len(keys) == distinct


def test_kxk_bench_finds_the_exact_1x1_and_depthwise_units():
    """``--what exact1x1`` times the exact zoo yolov5s's 42 #9 units as 18
    rows (15 SILU with their tables, the three NONE heads without one),
    ``--what dw`` NanoDet's six #7 units as 5; each row's label is a key
    of the committed record of the kernel it replaced, which
    ``chip_smoke.py`` prints beside it."""
    import json
    from thingino_accel_tpu_torch import kxk_bench as KB
    records = KB.REPO / "thingino_accel_tpu_torch" / "records"
    eng, units = KB.exact_1x1_units("cpu")
    keys = {KB.exact_1x1_key(eng, u) for u in units}
    assert len(units) == 42 and len(keys) == 18
    assert sum(k[3] == "SILU" for k in keys) == 15
    assert all((u.lut is not None) == (u.node.attrs["activation"] == "SILU")
               for u in units)
    assert {KB.exact_1x1_label(k) for k in keys} == set(json.loads(
        (records / "dp4a_exact_1x1.json").read_text())["ms"])
    eng, units = KB.dw_units("cpu")
    keys = {KB.dw_key(eng, u) for u in units}
    assert len(units) == 6 and len(keys) == 5
    assert {KB.dw_label(k) for k in keys} == set(json.loads(
        (records / "dp4a_dw.json").read_text())["ms"])


def test_kxk_bench_finds_the_bottleneck_and_sppf_units():
    """``--what bneck`` times the planned real yolov5n's 10 #6 units as 6
    rows and the planned zoo yolov5s's 11 as 7 (every one SILU -> SILU
    with C = CM = O, K = 3), ``--what sppf`` the zoo yolov5s's one #4 unit;
    each row's label is a key of the committed record of the dp4a kernel it
    replaced, which ``chip_smoke.py`` prints beside it."""
    import json
    from thingino_accel_tpu_torch import kxk_bench as KB
    records = KB.REPO / "thingino_accel_tpu_torch" / "records"
    bneck = json.loads((records / "dp4a_bneck.json").read_text())["ms"]
    for path, n, distinct in (("planned_yolov5n", 10, 6),
                              ("zoo_yolov5s", 11, 7)):
        eng, units = KB.bneck_units(path, "cpu")
        keys = {KB.bneck_key(eng, u) for u in units}
        assert len(units) == n and len(keys) == distinct
        for (_, _, _, c), cm, o, k, _, act1, act2 in keys:
            assert c == cm == o and k == 3 and act1 == act2 == "SILU"
        assert {KB.bneck_label(k) for k in keys} == set(bneck[path])
    eng, units = KB.sppf_units("cpu")
    assert len(units) == 1
    assert {KB.sppf_label(KB.sppf_key(eng, u)) for u in units} == set(
        json.loads((records / "dp4a_sppf.json").read_text())["ms"])
