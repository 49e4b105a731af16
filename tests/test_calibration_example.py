"""End-to-end consumer of operator-STACK cotangents:
examples/example_calibration.py fits an uncertain self-Kerr coefficient
from synthesized trajectory data by differentiating the XLA scan engine
with respect to the operator stack. A regression in those cotangents fails
this test."""

import importlib.util
import os


def test_calibration_example_recovers_kerr():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "example_calibration.py")
    spec = importlib.util.spec_from_file_location("example_calibration",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    xi = mod.main()                 # asserts rel err < 1e-4 internally
    assert xi > 0
