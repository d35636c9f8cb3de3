"""The control at a size a test run holds: the reference one precision below
the configuration's, put in the program's place, fails the cell's limits.
(On the card `python3 bench_port/control.py --workload <cell> --seeds ...`
runs it at the cell's own size; the TF32 sweep exists only there.)"""

import pytest

from bench_port import control, harness
from conftest import tiny_config, tiny_traffic

BENCH = harness.load_benchmark()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_int4_control_fails(workload):
    cell = harness.find(BENCH["workloads"], workload, "workload")
    limits = harness.data("cells", workload)["limits"]
    got = control.control(workload, 31, "cpu", config=tiny_config(cell["config"], rows=8192),
                          traffic=tiny_traffic(cell["traffic"]))
    towers = got["int4_towers"]
    assert all(v > limits[k] for k, v in towers.items()), towers
    if "lower_sweep" in got and harness.data("configs", cell["config"])["index"]["dtype"] == "int8":
        sweep = got["lower_sweep"]
        assert any(v > limits[k] for k, v in sweep.items()), sweep


@pytest.mark.gpu
def test_the_tf32_control_fails_on_the_card(cuda):
    cell = harness.find(BENCH["workloads"], "b32-search-f32-4m", "workload")
    limits = harness.data("cells", "b32-search-f32-4m")["limits"]
    got = control.control("b32-search-f32-4m", 32, cuda,
                          config=tiny_config(cell["config"], rows=1 << 20))
    assert any(v > limits[k] for k, v in got["lower_sweep"].items()), got
