"""The realtime cell's files against BENCHMARK.json, and its seven
per-layer readers on a canned stretch. CPU only; from the repository's
root: python -m pytest benchmark/tests -q"""
import dataclasses
import types

import pytest

import _paths  # noqa: F401
import run
from benchlib import profile, sweep
from refpt.realtime.config import RTConfig

MANIFEST = run.read_manifest()
CELL = "city_rt_1080p"
READERS = ("device_launches.rt", "idle_share.rt", "trace_roofline.rt",
           "restir_device_ms.rt", "fill_device_ms.rt",
           "denoise_device_ms.rt", "fill_lane_occupancy.rt")


def test_the_realtime_cell_config_and_traffic():
    cell, traffic, cfg = run.load_cell(MANIFEST, CELL)
    assert cell["config"] == "city_realtime" and cell["chips"] == 1
    entry = [c for c in MANIFEST["configs"] if c["name"] == "city_realtime"]
    assert len(entry) == 1 and entry[0]["source"] == cfg["source"]
    assert cfg["reduced"] == ["scene"] and cfg["precision"] == "float32"
    # the port's realtime default, written out key by key, is what the
    # plain reference implements
    fields = {f.name for f in dataclasses.fields(RTConfig)}
    assert set(cfg["settings"]) == fields
    RTConfig(**cfg["settings"]).check()
    assert cfg["settings"]["max_diffuse_bounces"] == 3
    assert traffic["mode"] == "realtime"
    assert (traffic["width"], traffic["height"]) == (1920, 1080)
    assert traffic["warmup_frames"] == 4 and traffic["check"]["pixels"] == 1024
    e2e = {m["name"] for m in run.cell_metrics(MANIFEST, CELL, "end_to_end")}
    assert e2e == {"paths_per_s", "setup_s"}
    layer = {m["name"] for m in run.cell_metrics(MANIFEST, CELL,
                                                 "per_layer")}
    assert layer == set(READERS) | {"host_build_s"}
    for m in MANIFEST["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [CELL] and m["moves"] == "paths_per_s"


def test_the_sweep_turns_back_and_forth():
    assert [sweep.angle_deg(f) for f in (0, 1, 60, 61, 119, 120, 121)] == [
        0.0, 0.25, 15.0, 14.75, 0.25, 0.0, 0.25]
    eye0, target = (48.0, 14.0, 54.0), (0.0, 2.0, 0.0)
    assert sweep.eye(eye0, target, 0) == pytest.approx(eye0)
    e = sweep.eye(eye0, target, 60)
    r0 = (eye0[0] ** 2 + eye0[2] ** 2) ** 0.5
    assert (e[0] ** 2 + e[2] ** 2) ** 0.5 == pytest.approx(r0)
    assert e[1] == eye0[1] and e != pytest.approx(eye0)


def _stretch():
    # one frame from 0 to 100 us; kernels [10, 20] in restir_di, [30, 40]
    # in fill (a trace inside it, [32, 38]), [50, 60] in relax, [70, 74]
    # in taa, a copy [80, 85]
    ops = [(10.0, 20.0, "k_restir"), (30.0, 40.0, "k_fill"),
           (50.0, 60.0, "k_relax"), (70.0, 74.0, "k_taa"),
           (80.0, 85.0, "Memcpy DtoD")]
    spans = {"rtxpt:realtime/restir_di": [(9.0, 21.0)],
             "rtxpt:realtime/fill": [(29.0, 41.0)],
             "rtxpt:trace_closest": [(29.5, 41.0)],
             "rtxpt:realtime/relax": [(49.0, 61.0)],
             "rtxpt:realtime/taa": [(69.0, 75.0)]}
    st = profile.Stretch(ops=ops, spans=spans,
                         host=[(0.0, 100.0, profile.CALL_RANGE)],
                         calls=[(0.0, 100.0)])
    st.trace_work = [("trace_closest", 1000)]
    st.counters = {"bounce.live": 30, "bounce.width": 120,
                   "restir_di.valid": 7}
    return st


def _ctx(st, mode="realtime"):
    return types.SimpleNamespace(mode=mode, stretch=st, call_s=80e-6,
                                 host_build_s=2.0, triangles=10)


def _read(name, ctx):
    return run.load_file(run.BENCH / "metrics" / f"{name}.py",
                         "m_" + name.replace(".", "_")).read(ctx)


def test_realtime_readers_on_a_canned_stretch():
    ctx = _ctx(_stretch())
    assert _read("device_launches.rt", ctx) == 4
    # 39 us busy in a frame whose untraced walls take 80 us
    assert _read("idle_share.rt", ctx) == pytest.approx(100 * (1 - 39 / 80))
    work = 1000 * (28 + 16) + 10 * 36
    assert _read("trace_roofline.rt", ctx) == pytest.approx(
        100 * work / 3.35e12 / 10e-6)
    assert _read("restir_device_ms.rt", ctx) == pytest.approx(0.010)
    assert _read("fill_device_ms.rt", ctx) == pytest.approx(0.010)
    assert _read("denoise_device_ms.rt", ctx) == pytest.approx(0.014)
    assert _read("fill_lane_occupancy.rt", ctx) == pytest.approx(25.0)


def test_trace_roofline_rt_takes_the_harness_ranges_without_the_ports():
    st = _stretch()
    del st.spans["rtxpt:trace_closest"]
    st.spans["trace_closest"] = [(29.5, 41.0)]
    work = 1000 * (28 + 16) + 10 * 36
    assert _read("trace_roofline.rt", _ctx(st)) == pytest.approx(
        100 * work / 3.35e12 / 10e-6)


@pytest.mark.parametrize("name", READERS)
def test_realtime_readers_are_silent_elsewhere(name):
    # another mode, no stretch, or a program without the spans and
    # counters (the parent commit): nothing to read, no raise
    assert _read(name, _ctx(_stretch(), mode="reference")) is None
    assert _read(name, _ctx(None)) is None
    bare = profile.Stretch(ops=[], spans={}, host=[], calls=[(0.0, 1.0)])
    if name not in ("device_launches.rt", "idle_share.rt"):
        assert _read(name, _ctx(bare)) is None
