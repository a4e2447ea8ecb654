"""K5 and K6 (``csrc/outbox_compact.cu``) on the card: what a sweep of
layouts of the current source, and an older source, take at the shapes the
launcher sees.

Each layout is the current source built with ``-DK5_THREADS=T
-DK5_SLOTS=K`` into a library of its own under ``build/``
(``_variants.build``); it stands in for the shipped kernels by replacing
``outbox_pack_launch`` and ``outbox_compact_plan_launch`` in the loaded
library (``_variants.use``). With ``--baseline PATH`` (given again for
more) an older ``outbox_compact.cu`` (the parent commit's, say) is built
and timed beside them, and where the first one's checkout has the wrapper
beside ``csrc/`` (``../outbox_compact.py``) that wrapper's call is timed
against the current one's. For each variant, one JSON line:

1. at every shape, after holding all of K5's and K6's outputs bit-equal
   (``torch.equal``) to the plain version: K5's and K6's device time by
   the profiler (``chip_smoke.device_ms``, 20 launches);
2. ptxas' registers of each kernel it builds.

Then one line a shape: the launch floor (an empty kernel launched on the
grid K5 gives that shape, by the profiler) and K5's and K6's bytes bound
(``chip_smoke.k5_k6_bytes`` over 3.35 TB/s); one line of call times at
(144, 969): the event-timed call (``chip_smoke.cuda_ms``) and the host's
µs a call, of the current wrapper and the baseline's, in turns over
several rounds; one line of the host's µs for each piece of the current
wrapper (its checks, allocations, views, stream lookup, a ctypes launch
of an empty kernel) and of a whole K5 and K6 call. The last
line is the card's ``nvidia-smi --query-gpu=name,power.limit``. Exits 1
without a card.

    python3 tools/k5_layouts.py [--baseline PATH] [--layouts 256x4,512x2]
                                [--shapes 144x969,4096x1] [--out PATH]

A layout is ``TxK``: threads a row's block × slots a thread a tile.
"""
import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from _variants import Variant, build, parse_layout  # noqa: E402
from _variants import ptxas_report, smi, use  # noqa: E402

LAYOUTS = ("256x4", "128x8", "512x2", "1024x1", "256x8", "128x16", "256x2")
# (rows, cap): the main path's pack, a large square, a row of many tiles,
# and many short rows (cap 1, cap 256)
SHAPES = ("144x969", "4096x4096", "3x20011", "4096x1", "4096x256")
LAUNCHES = ("outbox_pack_launch", "outbox_compact_plan_launch")
KERNELS = {"k5": "11pack_kernelILb1E", "k6": "11pack_kernelILb0E"}


def registers(text: str) -> dict:
    """Registers of K5's and K6's kernels (and stack and spill bytes, where
    any) from ptxas' ``-v`` report."""
    rep = {}
    for name, r in ptxas_report(text).items():
        key = next((k for k, mangled in KERNELS.items() if mangled in name),
                   None)
        if key is None or "registers" not in r:
            continue
        rep[key] = r["registers"]
        if r.get("stack_bytes") or r.get("spill_stores") \
                or r.get("spill_loads"):
            rep[f"{key}_stack_bytes"] = r["stack_bytes"]
            rep[f"{key}_spill_bytes"] = r["spill_stores"] + r["spill_loads"]
    return rep


def shape_inputs(dev, rows: int, cap: int, seed: int):
    """Half the slots active, ±inf among the values; the main path's pack
    (144 × 969) has a budget of cap, as the compact exchange gives, every
    other shape a mixed one (below, at and past each row's count)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    act = rng.random((rows, cap)) < 0.5
    vals = rng.uniform(-5.0, 5.0, (rows, cap)).astype(np.float32)
    vals[rng.random((rows, cap)) < 0.05] = np.inf
    vals[rng.random((rows, cap)) < 0.05] = -np.inf
    count = act.sum(1)
    if (rows, cap) == (144, 969):
        lim = np.full(rows, cap)
    else:
        lim = np.choose(np.arange(rows) % 3, [count // 2, count, count + 1])
    return (torch.from_numpy(vals).to(dev), torch.from_numpy(act).to(dev),
            torch.from_numpy(lim.astype(np.int32)).to(dev), float("-inf"))


def held(args, what: str) -> None:
    """All of K5's and K6's outputs bit-equal to the plain version."""
    from repro_torch.kernels.outbox_compact import (outbox_compact_plan_cuda,
                                                    outbox_pack_cuda)
    from repro_torch.kernels.ref import (outbox_compact_plan_ref,
                                         outbox_pack_ref)
    for g, w in zip(outbox_pack_cuda(*args), outbox_pack_ref(*args)):
        cs.bitwise(g, w, f"K5 {what}")
    for g, w in zip(outbox_compact_plan_cuda(args[1]),
                    outbox_compact_plan_ref(args[1])):
        cs.bitwise(g, w, f"K6 {what}")


def host_us(fn, calls: int = 2000) -> float:
    """The host's µs a call of ``fn``, over ``calls`` calls without a
    synchronisation between them (a small kernel's call is host-bound)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e6


def load_wrapper(path: Path):
    spec = importlib.util.spec_from_file_location("baseline_outbox_compact",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def call_times(dev, variants, baseline_wrapper, rounds: int = 11) -> dict:
    """At (144, 969): the event-timed call (median of 21) and the host's µs
    a call of K5 and K6 through the current wrapper and kernel and, with a
    baseline, the baseline's wrapper and kernel, in turns (base, new, new,
    base) for ``rounds`` rounds; each reading's median and least over the
    rounds (the host is shared, so single readings spread widely)."""
    import statistics
    from repro_torch.kernels import outbox_compact as cur
    args = shape_inputs(dev, 144, 969, 0)
    base = next((v for v in variants if v.tag == "baseline"), None)
    sides = [("new", cur, None)]
    if base is not None and baseline_wrapper is not None:
        sides = [("baseline", baseline_wrapper, base)] + sides
    got = {}
    for _ in range(rounds):
        for tag, mod, variant in sides + sides[::-1]:
            use(variant)
            k5 = lambda: mod.outbox_pack_cuda(*args)              # noqa: E731
            k6 = lambda: mod.outbox_compact_plan_cuda(args[1])     # noqa: E731
            side = got.setdefault(tag, {})
            for key, fn in (("k5_call_ms", lambda: cs.cuda_ms(k5, reps=21)),
                            ("k6_call_ms", lambda: cs.cuda_ms(k6, reps=21)),
                            ("k5_host_us", lambda: host_us(k5)),
                            ("k6_host_us", lambda: host_us(k6))):
                side.setdefault(key, []).append(fn())
    use(None)
    return {tag: {key: {"median": statistics.median(vals), "min": min(vals)}
                  for key, vals in side.items()}
            for tag, side in got.items()}


def host_parts(dev, reps: int = 20000) -> dict:
    """The host's µs of each piece of a K5 call at (144, 969), each timed
    alone over ``reps`` repetitions: what the wrapper spends before and
    around its launch."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import outbox_compact as cur
    vals, act, lim, ident = shape_inputs(dev, 144, 969, 0)
    rows, cap = act.shape
    buf = torch.empty(2 * rows * cap + 2 * rows, dtype=torch.int32,
                      device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = {
        "check_rows": lambda: cur._check_rows(act, "K5"),
        "need": lambda: _build.need(vals, "slot_vals", torch.float32, dev,
                                    (rows, cap)),
        "torch_empty": lambda: torch.empty((rows, cap), dtype=torch.int32,
                                           device=dev),
        "int_outputs": lambda: cur._int_outputs(dev, rows, cap, 2),
        "as_strided": lambda: buf.as_strided((rows, cap), (cap, 1), 0),
        "data_ptr": lambda: act.data_ptr(),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes_empty_launch": lambda: lib.outbox_launch_floor(
            rows, dev.index, stream),
        "k5_call": lambda: cur.outbox_pack_cuda(vals, act, lim, ident),
        "k6_call": lambda: cur.outbox_compact_plan_cuda(act),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) / reps * 1e6
    return out


def main() -> None:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, action="append", default=[])
    ap.add_argument("--layouts", default=",".join(LAYOUTS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    dev = cs.environment()
    card = smi("name,power.limit")
    from repro_torch.kernels import _build
    from repro_torch.kernels.outbox_compact import (
        k5_layout, launch_floor_cuda, outbox_compact_plan_cuda,
        outbox_pack_cuda)
    variants = [Variant(lay, _build.CSRC / "outbox_compact.cu",
                        parse_layout("k5_layouts", lay, "K5_THREADS",
                                     "K5_SLOTS", {}))
                for lay in args.layouts.split(",") if lay]
    baseline_wrapper = None
    for k, path in enumerate(args.baseline):
        variants.insert(k, Variant(f"baseline{k or ''}", path, {}))
    if args.baseline:
        wrapper = args.baseline[0].resolve().parent.parent / \
            "outbox_compact.py"
        if wrapper.exists():
            baseline_wrapper = load_wrapper(wrapper)
    build(variants, "k5_variants", LAUNCHES)
    shapes = [tuple(int(x) for x in s.split("x"))
              for s in args.shapes.split(",") if s]
    inputs = {s: shape_inputs(dev, *s, seed=i) for i, s in enumerate(shapes)}
    rows = []
    for v in variants:
        use(v)
        row = {"k5_layout": v.tag, "defines": v.defines,
               "registers": registers(v.ptxas), "shapes": {}}
        for (r, c), a in inputs.items():
            held(a, f"{v.tag} at R {r} cap {c}")
            row["shapes"][f"{r}x{c}"] = {
                "k5_ms": cs.device_ms(lambda: outbox_pack_cuda(*a),
                                      "pack_kernel"),
                "k6_ms": cs.device_ms(lambda: outbox_compact_plan_cuda(a[1]),
                                      "pack_kernel")}
        rows.append(row)
        cs.log(json.dumps(row))
    use(None)
    floors = {}
    for (r, c), a in inputs.items():
        n_act = int(a[1].sum())
        k5_bytes, k6_bytes = cs.k5_k6_bytes(r, c, n_act)
        floors[f"{r}x{c}"] = {
            "floor_ms": cs.device_ms(lambda: launch_floor_cuda(r, dev),
                                     "empty_kernel"),
            "k5_bound_ms": k5_bytes / cs.HBM_BYTES_PER_S * 1e3,
            "k6_bound_ms": k6_bytes / cs.HBM_BYTES_PER_S * 1e3,
            "active_slots": n_act}
        cs.log(json.dumps({"shape": f"{r}x{c}", **floors[f"{r}x{c}"]}))
    calls = call_times(dev, variants, baseline_wrapper)
    cs.log(json.dumps({"calls_144x969": calls}))
    parts = host_parts(dev)
    cs.log(json.dumps({"host_us_144x969": parts}))
    main_shape = "144x969"
    summary = {"shipped": k5_layout(), "card": card}
    if all(main_shape in r["shapes"] for r in rows):
        summary["fastest_k5_at_144x969"] = min(
            rows, key=lambda r: r["shapes"][main_shape]["k5_ms"])["k5_layout"]
    cs.log(json.dumps(summary))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"rows": rows, "floors": floors, "calls": calls,
             "host_parts": parts, "summary": summary}, indent=1))
    torch.cuda.synchronize()
    cs.log(card)


if __name__ == "__main__":
    main()
