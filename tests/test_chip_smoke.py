"""The CPU-checkable pieces of ``chip_smoke.py``: it refuses to run without
a GPU, and its last line has the driver's format."""

import importlib.util
import json
import os

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [[], ["--four-gpus"]])
def test_refuses_without_gpu(argv, capsys):
    smoke = _load()
    assert smoke.main(argv) == 2
    out, err = capsys.readouterr()
    assert "needs a GPU" in err
    assert '"ok"' not in out  # no result line


class _FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_last_line_format():
    smoke = _load()
    line = json.dumps(smoke.result_line([_FakeDevice()] * 4))
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.mark.parametrize("err, ok", [(1e-6, True), (2e-4, False),
                                     (np.nan, False), (np.inf, False)])
def test_phase_gate(err, ok, capsys):
    smoke = _load()
    p = smoke.Phase("x")
    p.check("label", err, 1e-4, "F32", 0.0)
    assert (p.failures == []) == ok
    assert ("PASS" if ok else "FAIL") in capsys.readouterr().out
