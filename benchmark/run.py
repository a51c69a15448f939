"""Runs one cell of the benchmark of rtxpt_tpu_torch, the PyTorch and CUDA
port, on the machine it is started on, and prints the result as the last
line of standard output. From the root of a checkout:

    python3 benchmark/run.py --workload art_ref_800x600 --seed 7 \\
        --seconds 10 --trace 0

A cell of BENCHMARK.json pairs a configuration
(`benchmark/configs/<config>.json`) with a traffic mix
(`benchmark/traffic/<traffic>.json`), which names its mode, whose driver is
`benchmark/modes/<mode>.py`. The metrics of the cell are those of
BENCHMARK.json that list it (or list no cells): with `--trace 0` the
end-to-end metrics, which the mode's driver takes itself; with `--trace
1` the per-layer metrics, each read from the profiled stretch by
`benchmark/metrics/<name>.py`. A cell, a configuration, a mode or a
metric is added as a file of its own; this file needs no edit for it.

The run fails (exit code other than 0, no result) without a CUDA device,
with fewer devices than the cell asks for, where the reference's sources
import the port, JAX or the JAX package, and where JAX, jaxlib, flax or
the JAX package is loaded once the window has closed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import ast  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# kernel caches at fixed paths inside the checkout (the port's own build
# directory, rtxpt_tpu_torch/_build/, is inside it already)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# whole top-level module names; the port's name begins with the last one
FORBIDDEN = ("jax", "jaxlib", "flax", "rtxpt_tpu")
PORT = "rtxpt_tpu_torch"


def forbidden_loaded(modules=None):
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def imports_of(path: Path):
    """Top-level names of the modules a source file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def reference_violations():
    """Files of the reference (refpt) and of the benchmark's own library
    that import the port, JAX or the JAX package."""
    bad = []
    for d in ("refpt", "benchlib"):
        for f in sorted((BENCH / d).rglob("*.py")):
            hit = imports_of(f) & (set(FORBIDDEN) | {PORT})
            if hit:
                bad.append(f"{f.relative_to(BENCH)}: {sorted(hit)}")
    return bad


_BAD = reference_violations() + [f"loaded: {m}" for m in forbidden_loaded()]
if _BAD and __name__ == "__main__":
    print("benchmark: refused: " + "; ".join(_BAD), file=sys.stderr)
    sys.exit(3)


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, kind: str):
    """The metrics of kind `kind` ('end_to_end', 'per_layer') of a cell."""
    return [m for m in manifest[kind]
            if cell in m.get("workloads", [cell])]


def load_cell(manifest: dict, name: str):
    """(cell, traffic, config) dicts of a cell of BENCHMARK.json, by name:
    the traffic is benchmark/traffic/<traffic>.json, the configuration
    benchmark/configs/<config>.json."""
    cells = [c for c in manifest["workloads"] if c["name"] == name]
    if len(cells) != 1:
        raise SystemExit(f"benchmark: no cell {name!r} in BENCHMARK.json")
    cell = cells[0]
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{cell['config']}.json")
                     .read_text())
    return cell, traffic, cfg


def read_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def execute(workload: str, seed: int, seconds: float, trace: bool):
    """Run one cell on the CUDA device: (the result's object, every number
    the check computed). The caller makes the module check."""
    manifest = read_manifest()
    cell, wl, cfg = load_cell(manifest, workload)
    mode = load_file(BENCH / "modes" / f"{wl['mode']}.py",
                     f"bench_mode_{wl['mode']}")
    ctx = types.SimpleNamespace(workload=wl, config=cfg, seed=seed,
                                seconds=seconds, trace=trace, device="cuda",
                                t_process=T_PROCESS)
    res = mode.run(ctx)
    metrics = {}
    if not trace:
        for m in cell_metrics(manifest, workload, "end_to_end"):
            metrics[m["name"]] = {"value": res["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    else:
        rctx = types.SimpleNamespace(
            mode=wl["mode"], stretch=res["stretch"], call_s=res["call_s"],
            host_build_s=res["host_build_s"], triangles=res["triangles"])
        for m in cell_metrics(manifest, workload, "per_layer"):
            reader = load_file(BENCH / "metrics" / f"{m['name']}.py",
                               "bench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(rctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    import torch
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": int(cell["chips"]),
           "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    st = res["stretch"]
    if trace and st is not None:
        from benchlib import profile
        dev["busy_s"] = profile.busy_us(st) * 1e-6
        dev["window_s"] = st.wall_us * 1e-6
        out["breakdown"] = profile.breakdown(st)
    out["checks"] = {k: {"value": res["numbers"][k], "limit": lim}
                     for k, lim in res["limits"].items()}
    return out, res["numbers"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    cell, _, _ = load_cell(read_manifest(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, numbers = execute(args.workload, args.seed, args.seconds,
                           bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: refused: loaded after the window: {bad}",
              file=sys.stderr)
        return 4
    print(f"card: {card_line()}", file=sys.stderr)
    print("numbers: " + json.dumps(numbers), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
