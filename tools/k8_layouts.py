"""K8 (``csrc/mamba_scan.cu``) at ``chip_smoke.py`` phase 4e's shape (B 4,
L 2048, D 8192, N 16, bf16 x, δ, B and C, float32 y and h_last): what an
older source and a sweep of layouts of the current one take on the card.

Each layout is the current source built with ``-DK8_LANES=S
-DK8_CHANNELS=C`` (and ``K8_STEPS``, ``K8_STAGES``, ``K8_UNROLL``) into a
library of its own under ``build/`` (``_variants.build``); it stands in for
the shipped kernel by replacing ``mamba1_scan_launch`` in the loaded
library (``_variants.use``). With ``--baseline PATH`` an older
``mamba_scan.cu`` (the parent commit's, say) is built and timed beside
them. For each, one JSON line:

1. device time by the profiler (``chip_smoke.device_ms``, 10 launches),
   after holding y and h_last to the plain version (``torch.equal`` for a
   layout of the current source; allclose at 1e-5 for the baseline), and
   the same at B 1 (``ms_b1``: a one-prompt prefill's layer);
2. ptxas' registers and spill bytes of ``scan_kernel<bf16, float>``;
3. the SASS mix per (l, n) step (``cuobjdump -sass``): the innermost loop
   holding the most MUFU.EX2, its instructions by class over its
   MUFU.EX2 count (one exp a (l, n));
4. the share of K8's bound (``chip_smoke.k8_bound``: exps over the SFU,
   FLOP, bytes) and the exps a second.

Then the card's name, power limit and maximum SM clock, and its SM clock
and power draw read while the shipped layout runs. Exits 1 without a card.

    python3 tools/k8_layouts.py [--baseline PATH] [--layouts 4x64,8x32s16]
                                [--out PATH]

A layout is ``SxC`` with optional ``s<steps>``, ``r<stages>``,
``u<unroll>``.
"""
import argparse
import json
import re
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from _variants import Variant, parse_layout, ptxas_report  # noqa: E402
from _variants import build, smi, use  # noqa: E402

LAYOUTS = ("2x32", "2x64", "2x128", "4x32", "4x64", "8x32", "8x64", "16x32",
           "16x64")
KEYS = {"s": "K8_STEPS", "r": "K8_STAGES", "u": "K8_UNROLL"}
CLASSES = (("fp32", ("FFMA", "FMUL", "FADD", "FSEL", "FSETP", "FMNMX")),
           ("mufu", ("MUFU",)), ("lds", ("LDS",)), ("sts", ("STS",)),
           ("shfl", ("SHFL",)))
LAUNCHES = ("mamba1_scan_launch",)


def defines_of(layout: str) -> dict:
    return parse_layout("k8_layouts", layout, "K8_LANES", "K8_CHANNELS",
                        KEYS)


def build_variants(variants, sass: bool = True) -> None:
    """Build every variant's library in parallel, load its
    ``mamba1_scan_launch`` and, with ``sass``, disassemble it."""
    build(variants, "k8_variants", LAUNCHES, sass=sass)


def is_path_kernel(name: str) -> bool:
    """``scan_kernel<__nv_bfloat16, float>`` (N = 16, no pad), mangled."""
    return ("scan_kernelI13__nv_bfloat16f" in name
            and "Lb1E" not in name)


def path_report(text: str) -> dict:
    """Registers and spill bytes of the path's kernel, from ``-Xptxas -v``."""
    rep = next((r for name, r in ptxas_report(text).items()
                if is_path_kernel(name) and "registers" in r), {})
    return {k: rep[k] for k in ("registers", "spill_stores", "spill_loads")
            if k in rep}


def sass_mix(text: str) -> dict:
    """Instructions per (l, n) step by class in the path kernel's walk:
    the innermost loop (a backward branch with no other inside it) with
    the most MUFU.EX2, over its MUFU.EX2 count."""
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs[1:] if is_path_kernel(f.split()[0])), None)
    if body is None:
        return {"error": "scan_kernel<bf16, float> not in the SASS"}
    ins = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            ins.append((int(m[1], 16), m[2], m[3]))
    loops = []
    for addr, op, args in ins:
        t = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and t and int(t[1], 16) <= addr:
            loops.append((int(t[1], 16), addr))
    inner = [lp for lp in loops if not any(
        o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]

    def ops_in(lp):
        return [op for a, op, _ in ins if lp[0] <= a <= lp[1]]
    best = max(inner, key=lambda lp: ops_in(lp).count("MUFU.EX2"),
               default=None)
    ops = ops_in(best) if best else []
    ex2 = ops.count("MUFU.EX2")
    if not ex2:
        return {"error": "no loop with MUFU.EX2 found"}
    by = Counter()
    for op in ops:
        head = op.split(".")[0]
        by[next((c for c, heads in CLASSES if head in heads), "other")] += 1
    return {"loop_instructions": len(ops), "loop_ex2": ex2,
            "per_ln": {k: by[k] / ex2 for k in
                       [c for c, _ in CLASSES] + ["other"]},
            "per_ln_total": len(ops) / ex2,
            "other_ops": dict(Counter(op for op in ops if not any(
                op.split(".")[0] in heads for _, heads in CLASSES)))}


def clock_under_load(run, calls: int = 2000) -> str:
    """The SM clock and power draw by nvidia-smi while launches of ``run``
    are still queued on the card (the host blocks once the launch queue is
    full, so most of ``calls`` run after the loop)."""
    import torch
    for _ in range(calls):
        run()
    seen = smi("clocks.sm,power.draw")
    torch.cuda.synchronize()
    return seen


def main() -> None:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--layouts", default=",".join(LAYOUTS))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    dev = cs.environment()
    card = smi("name,power.limit,clocks.max.sm")
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import (k8_layout, mamba1_scan_cuda,
                                                mamba1_scan_ref)
    variants = [Variant(lay, _build.CSRC / "mamba_scan.cu", defines_of(lay))
                for lay in args.layouts.split(",") if lay]
    if args.baseline is not None:
        variants.insert(0, Variant("baseline", args.baseline, {}))
    build_variants(variants)
    x = cs.mamba_inputs(dev, "bfloat16", B=cs.LM_BATCH, L=cs.LM_PROMPT)
    B, L, D = x[0].shape
    N = x[4].shape[1]
    bound = cs.k8_bound(B, L, D, N, cs.k8_bytes(B, L, D, N, 2, 4, 1),
                        cs.sm_clock_hz())
    x1 = tuple(t[:1].contiguous() for t in x[:4]) + (x[4],)
    call = dict(return_state=True, y_dtype=torch.float32)
    want = {4: mamba1_scan_ref(*x, **call), 1: mamba1_scan_ref(*x1, **call)}
    rows = []
    for v in variants:
        use(v)
        ms, err = {}, 0.0                  # by batch
        for b, args_ in ((4, x), (1, x1)):
            got = mamba1_scan_cuda(*args_, **call)
            torch.cuda.synchronize()
            if v.tag == "baseline":
                err = max([err] + [cs.held(g, w, cs.TOL["float32"],
                                           "K8 baseline")
                                   for g, w in zip(got, want[b])])
            else:
                err = max([err] + [cs.bitwise(g, w, f"K8 {v.tag} B {b}")
                                   for g, w in zip(got, want[b])])
            del got
            ms[b] = cs.device_ms(lambda: mamba1_scan_cuda(*args_, **call),
                                 "scan_kernel", reps=10)
        row = {"k8_layout": v.tag, "defines": v.defines, "ms": ms[4],
               "ms_b1": ms[1], "max_abs_err": err,
               "share_of_bound": bound["bound_ms"] / ms[4],
               "exps_per_s": bound["exps"] / ms[4] * 1e3,
               **path_report(v.ptxas), "sass": sass_mix(v.sass),
               "card": card}
        rows.append(row)
        cs.log(json.dumps(row))
    use(None)
    load = clock_under_load(lambda: mamba1_scan_cuda(*x, **call))
    summary = {"k8_layouts_card": card, "shipped": k8_layout(),
               "clocks_sm_power_draw_under_load": load, **bound,
               "fastest": min(rows, key=lambda r: r["ms"])["k8_layout"]}
    cs.log(json.dumps(summary))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"rows": rows, "summary": summary},
                                       indent=1))


if __name__ == "__main__":
    main()
