"""Run one benchmark cell once and print its result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is the ``workloads`` entry of ``BENCHMARK.json`` named
``--workload``; its configuration is ``configs/<config>.json`` (the file the
manifest names), its traffic ``traffic/<traffic>.json``, whose ``kind`` names
the module of ``kinds/`` that drives it, and its limits
``limits/<workload>.json``. A per-layer metric ``<name>`` is read by
``metrics/<name>.py``, or else by ``metrics/<name up to its first dot>.py``.
Adding a configuration, a traffic mix, a cell or a metric is adding files
and manifest entries.

A run: the model and its inputs from ``--seed`` (weights made on the card),
the warm-up of the cell's own shapes (the first run in a checkout also
builds the port's CUDA library into ``dl_biomass_tpu_torch/build/``), the
window of ``--seconds``, with ``--trace 1`` a profiled stretch after it,
then the check against the plain reference. The last line of standard
output is the result; the last lines of standard error give each number
compared beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "dl_biomass_tpu")


def fixed_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no library
    may pull JAX in."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``dl_biomass_tpu_torch`` is not ``dl_biomass_tpu``."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(manifest: dict, workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``workload`` with its configuration, traffic, limits and metrics."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]

    def reports(metric) -> bool:
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in manifest["end_to_end"] if reports(m)]
    per_layer = [m for m in manifest["per_layer"] if reports(m)]
    return SimpleNamespace(
        cell=cell,
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"portbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {HERE / 'metrics'}")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def judge(numbers: dict, limits: dict) -> bool:
    """Every number compared at or under its limit (a missing one fails)."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())


def _program_part(spec: SimpleNamespace, ctx: SimpleNamespace, seconds: float,
                  traced: bool):
    """Set-up, window, traced stretch and release on this rank: (the kind,
    the run's peak bytes); the set-up's start and end are on the kind."""
    import torch

    kind = importlib.import_module(f"portbench.kinds.{spec.traffic['kind']}")
    k = kind.Kind(ctx)
    cuda = ctx.device.type == "cuda"
    k.setup_start = time.perf_counter()
    k.setup()
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    k.setup_end = time.perf_counter()
    k.window(seconds)
    if cuda:
        k.summary["window_peak_bytes"] = torch.cuda.max_memory_allocated()
    if traced:
        k.traced()
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) if cuda else 0
    k.release()
    return k, peak


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join(rank: int, world: int, port: int, device):
    """This process as ``rank`` of ``world`` ranks on this machine, one card
    each (nccl; gloo on the CPU), over a ``dp`` mesh: (mesh, device)."""
    import datetime

    import torch
    import torch.distributed as dist

    from dl_biomass_tpu_torch.parallel import mesh as dp

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    return dp.make_mesh(dp=world, device=dev.type), dev


def _rank_main(rank, world, port, spec, seed, seconds, traced, device, queue):
    """A rank other than 0: the program's part of the run; reports its peak,
    its traced busy time and the forbidden modules it loaded."""
    import torch.distributed as dist

    fixed_environment()
    try:
        if getattr(spec, "before", None):  # a test breaks the path in every rank
            spec.before()
        mesh, dev = _join(rank, world, port, device)
        ctx = SimpleNamespace(seed=int(seed), config=spec.config, traffic=spec.traffic,
                              device=dev, mesh=mesh, rank=rank, world=world)
        k, peak = _program_part(spec, ctx, seconds, traced)
        t = k.summary.get("trace", {})
        queue.put({"rank": rank, "peak": peak, "busy_s": t.get("busy_s"),
                   "forbidden": forbidden_modules(list(sys.modules))})
        dist.destroy_process_group()
    except BaseException as e:  # the parent must hear of it, then it re-raises
        queue.put({"rank": rank, "error": repr(e)})
        raise


def run_cell(spec: SimpleNamespace, seed: int, seconds: float, traced: bool, device,
             t_start: float = T_START) -> dict:
    """One run of the cell on ``device``; returns the result line's object.
    A traffic of ``ranks`` > 1 runs that many processes, one card each, this
    one rank 0, which measures, checks and reports."""
    import torch

    from portbench.yardstick.work import PEAKS

    world = int(spec.traffic.get("ranks", 1))
    reports, procs = [], []
    ctx = SimpleNamespace(seed=int(seed), config=spec.config, traffic=spec.traffic,
                          device=torch.device(device), mesh=None, rank=0, world=world)
    if getattr(spec, "before", None):
        spec.before()
    if world > 1:
        import torch.multiprocessing as tmp

        port = _free_port()
        mpc = tmp.get_context("spawn")
        queue = mpc.SimpleQueue()
        procs = [mpc.Process(target=_rank_main, args=(r, world, port, spec, seed, seconds,
                                                      traced, device, queue))
                 for r in range(1, world)]
        for p in procs:
            p.start()
        ctx.mesh, ctx.device = _join(0, world, port, device)
    try:
        k, peak = _program_part(spec, ctx, seconds, traced)
        if world > 1:
            import torch.distributed as dist

            reports = [queue.get() for _ in procs]
            dist.destroy_process_group()
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [r["error"] for r in reports if "error" in r]
    if errors:
        raise RuntimeError(f"a rank failed: {errors}")
    cuda = ctx.device.type == "cuda"
    setup_s = k.setup_end - t_start
    numbers = k.check("program")
    correct = judge(numbers, spec.limits) and k.failed == 0
    k.summary["peaks"] = PEAKS
    if traced:
        metrics = {}
        for m in spec.per_layer:
            v = metric_reader(m["name"])(k.summary)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(k.e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in spec.end_to_end}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(spec.cell["chips"]) if cuda else 1,
                   "memory_peak_bytes": int(max([peak] + [r["peak"] for r in reports])),
                   "power": power_limit() if cuda else "n/a"}
    out = {"correct": bool(correct), "attempted": int(k.attempted), "failed": int(k.failed),
           "metrics": metrics, "device": device_info}
    if traced:
        t = k.summary["trace"]
        busy = [t["busy_s"]] + [r["busy_s"] for r in reports]
        device_info.update(busy_s=sum(busy) / len(busy), window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["notes"] = {key: v for key, v in k.summary.items()
                    if key not in ("trace", "peaks")}
    out["notes"].update(setup_s=setup_s, setup_start_s=k.setup_start - t_start)
    if traced:
        out["notes"]["trace"] = {key: v for key, v in k.summary["trace"].items()
                                 if key not in ("device_ops", "idle_gaps")}
    out["notes"]["ranks_forbidden"] = sorted({m for r in reports for m in r["forbidden"]})
    out["checks"] = {name: {"value": numbers.get(name), "limit": lim}
                     for name, lim in spec.limits.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_environment()
    spec = resolve(load_manifest(), args.workload)

    import torch

    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules(list(sys.modules)) + out["notes"]["ranks_forbidden"]
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
