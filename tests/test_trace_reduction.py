"""The reduction from a profiler trace to window, idle share and kernel
table (``benchmarks/trace_flagship.py``), on small recorded traces."""
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.profiler import ProfileData

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "benchmarks"))
import trace_flagship as tf  # noqa: E402

# Two streams: a 4 us and a 1 us kernel on the compute stream, a 2 us
# copy on another stream that overlaps the first kernel by 1 us, and a
# derived line that repeats a kernel.  Window 1000..7000 ns.
_STREAMS = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #7(Compute)"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 4000000 }
    events { metadata_id: 2 offset_ps: 5000000 duration_ps: 1000000 }
  }
  lines {
    id: 2
    name: "Stream #9(MemcpyD2D)"
    timestamp_ns: 4000
    events { metadata_id: 3 offset_ps: 0 duration_ps: 2000000 }
  }
  lines {
    id: 3
    name: "XLA Ops"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 4000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "input_reduce_fusion.1" } }
  event_metadata { key: 2 value { id: 2 name: "loop_select_fusion" } }
  event_metadata { key: 3 value { id: 3 name: "MemcpyD2D" } }
}
"""


def test_reduce_recorded_trace_streams():
    events, lines = tf.device_events(ProfileData.from_text_proto(_STREAMS))
    assert lines == ["Stream #7(Compute)", "Stream #9(MemcpyD2D)"]
    out = tf.reduce_trace(events, num_steps=2, outputs={
        "input_reduce_fusion_1": "f32[8,16,16]"})
    assert out["window_ms"] == pytest.approx(6e-3)
    assert out["ms_per_step"] == pytest.approx(3e-3)
    # Busy: 1000..6000 (kernel and overlapping copy) + 6000..7000.
    assert out["busy_share"] == pytest.approx(1.0)
    assert [k["name"] for k in out["kernels"]] == [
        "input_reduce_fusion.1", "MemcpyD2D", "loop_select_fusion"]
    top = out["kernels"][0]
    assert top["share"] == pytest.approx(4 / 6)
    assert top["us_per_step"] == pytest.approx(2.0)
    assert top["output"] == "f32[8,16,16]"


def test_reduce_recorded_trace_without_stream_lines():
    text = _STREAMS.replace("Stream #7(Compute)", "Compute") \
        .replace("Stream #9(MemcpyD2D)", "Copies")
    events, lines = tf.device_events(ProfileData.from_text_proto(text))
    # The derived "XLA Ops" line is never counted.
    assert lines == ["Compute", "Copies"]
    out = tf.reduce_trace(events, num_steps=1)
    assert out["num_events"] == 3


@pytest.mark.parametrize("intervals, length", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 1), (0.5, 0.75)], 2.0),
    ([(0, 4), (1, 2), (3, 5), (7, 8)], 6.0),
])
def test_union_ns(intervals, length):
    assert tf.union_ns(intervals) == length


def test_idle_share_of_gapped_trace():
    events = [("a", 0.0, 2.0), ("b", 6.0, 8.0), ("a", 8.0, 10.0)]
    out = tf.reduce_trace(events, num_steps=1)
    assert out["idle_share"] == pytest.approx(0.4)
    assert out["kernels"][0] == pytest.approx(
        {"name": "a", "calls": 2, "ms": 4e-6, "share": 0.4,
         "us_per_step": 4e-3, "output": None})


def test_fusion_outputs_find_pair_shaped_buffers():
    def pairs(x):
        d = x[:, :, None] - x[:, None, :]
        mask = jnp.abs(d) < 0.5
        return jnp.where(mask, d * d, 0.0), jnp.sum(jnp.sin(d), axis=-1)

    x = np.zeros((4, 8), np.float32)
    hlo = jax.jit(pairs).lower(x).compile().as_text()
    outputs = tf.fusion_outputs(hlo)
    assert outputs and all("{" not in v for v in outputs.values())
    assert any("[4,8,8]" in v for v in tf.pair_shaped(outputs, 8).values())
    assert not tf.pair_shaped(outputs, 5)


@pytest.mark.filterwarnings(
    "ignore:the optimum block size criterion:RuntimeWarning")
def test_run_variant_on_cpu_trace(tmp_path):
    # Wiring of Proc.profile_dir -> trace -> reduction, at a tiny size on
    # the CPU, whose XLA threads stand in for the card's streams.
    params = dict(nop=8, target=64, max_w=80, nts=32, burn=1, blocks=2,
                  itc_lags=2)
    out = tf.run_variant(params, True, str(tmp_path),
                         plane_name="/host:CPU", line_prefix="tf_XLA")
    assert out["num_time_steps"] == 32
    assert 0.0 <= out["idle_share"] <= 1.0 and out["window_ms"] > 0
    # The second block runs untraced and is timed.
    assert out["untraced_ms_per_step"] > 0
    assert out["busy_ms_per_step"] == pytest.approx(
        out["busy_share"] * out["ms_per_step"])
    # The traced block's fusions are found in its compiled HLO.
    assert any(k["output"] for k in out["kernels"])
    saved = json.loads((tmp_path / "kernels.json").read_text())
    assert saved["window_ms"] == out["window_ms"]
    assert len(saved["kernels"]) == len(out["kernels"])
