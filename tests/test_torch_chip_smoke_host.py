"""``chip_smoke.py``'s host line on the CPU: the CPU model, the cores and a
fixed host-only probe that ends well inside its 2 s, and the script's
refusal, with no result line, where there is no CUDA device.

Tolerances: none.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_host_info_names_the_host(smoke):
    host = smoke.host_info()
    assert host["affinity"] == sorted(os.sched_getaffinity(0))
    with open("/proc/cpuinfo") as f:
        models = [ln.split(":", 1)[1].strip() for ln in f
                  if ln.startswith("model name")]
    assert host["cpu_model"] == (models[0] if models else None)
    assert host["probe_iters"] == smoke.HOST_PROBE_ITERS
    # every repeat together stays inside the 2 s the probe may take
    assert 0 < host["probe_ms"] * smoke.HOST_PROBE_REPEATS < 2000
    json.dumps(host)


def test_no_card_no_result(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert smoke.main() != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and not out.strip()
