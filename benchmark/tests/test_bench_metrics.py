"""The benchmark's own arithmetic on canned inputs: the reduction of a
profiled stretch, the roofline's bytes, the seeded inputs and the check
of loaded modules. CPU only."""
import numpy as np
import pytest

import _paths  # noqa: F401
import run
from benchlib import check, peaks, profile, scenes


def _stretch():
    # one call from 0 to 100 us; kernels [10, 20], [15, 30], [50, 60],
    # a copy [70, 75]; a trace call's device span [12, 55]
    ops = [(10.0, 20.0, "k_a"), (15.0, 30.0, "k_b"), (50.0, 60.0, "k_a"),
           (70.0, 75.0, "Memcpy HtoD")]
    host = [(0.0, 100.0, profile.CALL_RANGE),
            (11.0, 56.0, "trace_closest"), (30.0, 50.0, "aten::nonzero")]
    st = profile.Stretch(ops=ops, spans={"trace_closest": [(12.0, 55.0)]},
                         host=host, calls=[(0.0, 100.0)])
    st.trace_work = [("trace_closest", 1000), ("trace_anyhit", 500)]
    return st


def test_union_and_busy_and_gaps():
    st = _stretch()
    assert profile.union(st.ops) == [(10.0, 30.0), (50.0, 60.0),
                                     (70.0, 75.0)]
    assert profile.busy_us(st) == 35.0
    assert profile.idle_gaps(st) == [(0.0, 10.0), (30.0, 50.0),
                                     (60.0, 70.0), (75.0, 100.0)]
    assert len(st.kernels) == 3 and st.wall_us == 100.0


def test_kernels_attributed_to_the_span_they_start_in():
    st = _stretch()
    # k_b (15..30) and k_a (50..60) start inside [12, 55]; k_a at 10 does not
    assert profile.inside_us(st, profile.TRACE_RANGES) == 25.0


def test_breakdown_names_and_orders():
    b = profile.breakdown(_stretch())
    assert b["device_ops"][0][0] == "k_a"
    assert b["device_ops"][0][1] == pytest.approx(20e-6)
    assert [g[0] for g in b["idle_gaps"][:2]] == [
        f"{profile.CALL_RANGE}/python", "trace_closest/aten::nonzero"]
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx(
        [25e-6, 20e-6, 10e-6, 10e-6])


def test_metric_readers_on_a_canned_stretch():
    import types
    st = _stretch()
    ctx = types.SimpleNamespace(mode="reference", stretch=st, call_s=50e-6,
                                host_build_s=1.5, triangles=10)
    read = lambda n: run.load_file(run.BENCH / "metrics" / f"{n}.py",
                                   "m").read(ctx)
    assert read("host_build_s") == 1.5
    assert read("device_launches.ref") == 3
    # 35 us busy in the profiled call; untraced calls take 50 us
    assert read("idle_share.ref") == pytest.approx(30.0)
    work = 1000 * (28 + 16) + 500 * (28 + 1) + 2 * 10 * 36
    assert read("trace_roofline.ref") == pytest.approx(
        100 * work / 3.35e12 / 25e-6)
    ctx.mode = "realtime"
    assert read("idle_share.ref") is None


def test_trace_bytes():
    assert peaks.trace_bytes("trace_closest", 2, 3) == 2 * 44 + 3 * 36
    assert peaks.trace_bytes("trace_anyhit", 2, 3) == 2 * 29 + 3 * 36


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40])
def test_seeded_inputs_repeat(seed):
    draw = lambda s: check.draw_pixels(scenes.seed_rng(s), 800, 600, 64)
    a = draw(seed)
    assert np.array_equal(a, draw(seed))
    assert len(set(a.tolist())) == 64 and a.min() >= 0 and a.max() < 480000
    assert not np.array_equal(a, draw(seed + 1))


def test_forbidden_modules_by_whole_top_level_name():
    assert run.forbidden_loaded(["rtxpt_tpu_torch", "rtxpt_tpu_torch.ops",
                                 "jaxtyping", "numpy"]) == []
    assert run.forbidden_loaded(["rtxpt_tpu.ops.bvh", "jax.numpy",
                                 "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "rtxpt_tpu"]


def test_reference_imports_neither_port_nor_jax():
    assert run.reference_violations() == []


def test_a_reference_file_that_imports_the_port_is_found(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import rtxpt_tpu_torch.ops\nfrom jax import numpy\n")
    assert run.imports_of(f) == {"rtxpt_tpu_torch", "jax"}
