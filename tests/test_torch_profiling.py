"""PyTorch port, ``runtime/profiling.py`` on the CPU: ``device_trace`` writes a
Chrome trace of a render that names the render's ops. (On a card the same
trace names the kernels: chip_smoke.py counts K2 and K1 in it. The spans
and counters: ``test_torch_spans.py``.)"""

import json
import os

import pytest

from raytracing_course_2024_tpu_torch.runtime.profiling import device_trace
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from torch_parity import descs


def _trace_names(log_dir):
    path = os.path.join(log_dir, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events]


@pytest.mark.parametrize("engine", ["batch", "sticky"])
def test_device_trace_writes_a_chrome_trace_of_the_render(engine, tmp_path):
    """MIXED 16x12 at 2 spp: the trace holds the aten ops of the frame (the
    plain bounce's ``where`` and arithmetic, the tonemap's ``pow``), and the
    profiler sums them by name."""
    _, td = descs("mixed", 16, 12, 2)
    r = Renderer(td, device="cpu", engine=engine)
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir) as prof:
        img = r.render_u8(seed=1)
    assert img.shape == (12, 16, 3) and img.max() > 0
    names = _trace_names(log_dir)
    for op in ("aten::where", "aten::mul", "aten::pow"):
        assert op in names, op
    assert sum(e.count for e in prof.key_averages() if e.key == "aten::pow") >= 1


def test_device_trace_writes_nothing_when_the_block_raises(tmp_path):
    log_dir = str(tmp_path / "trace")
    with pytest.raises(KeyError):
        with device_trace(log_dir):
            raise KeyError("render failed")
    assert os.listdir(log_dir) == []

