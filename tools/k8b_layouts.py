"""K8b (``csrc/mamba_scan_bwd.cu``) at falcon-mamba-7b's training layer
(``chip_smoke.scan_backward_inputs``: B 4, L 2048, D 8192, N 16, bf16 x,
δ, B and C, float32 dy, no h0): what an older source and a sweep of
layouts of the current one take on the card.

Each layout is the current source built with ``-DK8B_LANES=S
-DK8B_CHANNELS=C`` (and ``K8B_STEPS``, ``K8B_STAGES``)
into a library of its own under ``build/``
(``_variants.build``); it stands in for the shipped kernel by replacing
``mamba1_scan_bwd_launch`` and ``mamba1_scan_bwd_scratch`` in the loaded
library (``_variants.use``). With
``--baseline PATH`` an older ``mamba_scan_bwd.cu`` (the parent commit's,
which sums dB, dC and dA by atomics into zeroed float32 outputs and sizes
its scratch by ``mamba1_scan_bwd_steps``) is built and called in its own
convention beside them. For each, one JSON line:

1. the checks: the bf16 layer and the same layer in float32 against
   ``mamba1_scan_bwd_ref`` (``chip_smoke.grads_held``, the smoke's
   tolerances), and for a layout of the current source two calls bit-equal
   in every output; a layout that fails a check is reported, not shipped;
2. device time by the profiler (``chip_smoke.device_ms``, 5 calls): the
   whole call (``ms``: every kernel it launches) and the scan kernel alone
   (``kernel_ms``), and a call by CUDA events (``call_ms``);
3. ptxas' registers and spill bytes of ``scan_bwd_kernel<bf16, float>``,
   and (current source) its shared bytes and resident blocks an SM;
4. the SASS mix per (l, n) step (``cuobjdump -sass``, :func:`sass_mix`):
   each step loop's instructions by class over the (l, n) it walks, and
   their sum;
5. the share of K8b's bound (``chip_smoke.k8b_bound``).

Then the card's name and power limit as nvidia-smi gives them, and the
fastest layout that held every check. Exits 1 without a card.

    python3 tools/k8b_layouts.py [--baseline PATH] [--layouts 4x64,2x128b2]
                                 [--out PATH]

A layout is ``SxC`` with optional ``s<steps>`` and ``r<stages>``. With
``--sass DIR`` each variant's SASS of the path kernel is written there.
"""
import argparse
import ctypes
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

LAYOUTS = ("2x64", "2x64r2", "2x32", "2x128", "4x64")
KEYS = {"s": "K8B_STEPS", "r": "K8B_STAGES"}
CLASSES = (("fp32", ("FFMA", "FMUL", "FADD", "FSEL", "FSETP", "FMNMX")),
           ("mufu", ("MUFU",)), ("lds", ("LDS",)), ("sts", ("STS",)),
           ("shfl", ("SHFL",)), ("sel", ("SEL",)),
           ("local", ("LDL", "STL")))
# the current source's calls a variant replaces (its scratch depends on
# its layout); the baseline replaces none
LAUNCHES = ("mamba1_scan_bwd_launch", "mamba1_scan_bwd_scratch")
OUT = ROOT / "chiprun_out" / "k8b_layouts.json"


def defines_of(layout: str) -> dict:
    return parse_layout("k8b_layouts", layout, "K8B_LANES", "K8B_CHANNELS",
                        KEYS)


def is_path_kernel(name: str) -> bool:
    """``scan_bwd_kernel<__nv_bfloat16, float[, true]>`` (the aligned
    instantiation; the baseline's has no third argument), mangled."""
    return re.search(r"scan_bwd_kernelI13__nv_bfloat16f(Lb1)?E", name) \
        is not None


def path_report(text: str) -> dict:
    """Registers and spill bytes of the path's kernel, from ``-Xptxas -v``."""
    rep = next((r for name, r in ptxas_report(text).items()
                if is_path_kernel(name) and "registers" in r), {})
    return {k: rep[k] for k in ("registers", "spill_stores", "spill_loads")
            if k in rep}


def path_sass(text: str) -> str:
    """The path kernel's part of ``cuobjdump -sass``."""
    funcs = re.split(r"\n\s*Function : ", text)
    return next((f for f in funcs[1:] if is_path_kernel(f.split()[0])), "")


def sass_mix(text: str, lanes: int) -> dict:
    """Instructions per (l, n) step of the path kernel, from each loop's
    own body (a backward branch; nested loops left out), in address
    order: a loop with MUFU.EX2 walks one exp a (l, n); one with SHFL and
    no exp is a reverse walk, 2·own − 1 + 2·log2(lanes) shuffles a step of
    own = 16 / lanes states. Each such loop's instructions by class over
    its (l, n) count, ``per_ln_total`` their sum, and ``per_chunk`` the
    instructions of the loops around them (staging, barriers, sums)."""
    body = path_sass(text)
    if not body:
        return {"error": "scan_bwd_kernel<bf16, float> not in the SASS"}
    own_n = 16 // lanes
    shfl_step = 2 * own_n - 1 + 2 * (lanes.bit_length() - 1)
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

    def own(lp):
        inner = [o for o in loops if o != lp and lp[0] <= o[0]
                 and o[1] <= lp[1]]
        return [op for a, op, _ in ins if lp[0] <= a <= lp[1]
                and not any(o[0] <= a <= o[1] for o in inner)]
    out, total, chunk = [], 0.0, 0
    for lp in sorted(set(loops)):
        ops = own(lp)
        ex2 = ops.count("MUFU.EX2")
        shfl = sum(op.startswith("SHFL") for op in ops)
        ln = ex2 or (shfl // shfl_step * own_n if shfl >= shfl_step else 0)
        if not ln:
            chunk += len(ops)
            continue
        by = Counter()
        for op in ops:
            head = op.split(".")[0]
            by[next((c for c, heads in CLASSES if head in heads),
                    "other")] += 1
        out.append({"instructions": len(ops), "ex2": ex2, "shfl": shfl,
                    "ln": ln, "per_ln": {k: by[k] / ln for k in
                                         [c for c, _ in CLASSES]
                                         + ["other"]},
                    "per_ln_total": len(ops) / ln,
                    "other_ops": dict(Counter(
                        op for op in ops if not any(
                            op.split(".")[0] in heads
                            for _, heads in CLASSES)).most_common(12))})
        total += len(ops) / ln
    if not out:
        return {"error": "no step loop found"}
    return {"loops": out, "per_ln_total": total, "per_chunk": chunk}


def baseline_call(v, args):
    """The older source's launch in its own convention: dB, dC and dA
    zeroed float32 (atomics), the scratch (B, ceil(L / steps), 16, D)."""
    import torch
    from repro_torch.kernels import _build
    x, dt, bv, cv, a, h0, dy = args
    B, L, D = x.shape
    N = a.shape[1]
    steps = v.lib.mamba1_scan_bwd_steps()
    dx, dd = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = (torch.zeros((B, L, N), dtype=torch.float32, device=x.device)
              for _ in range(2))
    dA = torch.zeros((D, N), dtype=torch.float32, device=x.device)
    scratch = torch.empty((B, -(-L // steps), 16, D), dtype=torch.float32,
                          device=x.device)
    err = v.launch["mamba1_scan_bwd_launch"](
        x.data_ptr(), dt.data_ptr(), bv.data_ptr(), cv.data_ptr(),
        a.data_ptr(), None, dy.data_ptr(), None, dx.data_ptr(),
        dd.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), None,
        scratch.data_ptr(), B, L, D, N, 1 if x.dtype == torch.bfloat16
        else 0, 1 if dy.dtype == torch.float32 else 0, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "baseline mamba1_scan_bwd")
    return dx, dd, dB.to(bv.dtype), dC.to(cv.dtype), dA, None


def layout_of(v) -> dict:
    """A current-source variant's ``mamba1_scan_bwd_layout``."""
    from repro_torch.kernels.mamba_scan import k8b_layout_of
    fn = v.lib.mamba1_scan_bwd_layout
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return k8b_layout_of(v.lib)


def checked(fn, *args) -> tuple:
    """``fn(*args)``, or the failure a chip_smoke check reported."""
    try:
        return fn(*args), None
    except SystemExit:
        return None, "failed (see the line above)"


def main() -> None:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--layouts", default=",".join(LAYOUTS))
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--sass", type=Path, default=None)
    args = ap.parse_args()
    dev = cs.environment()
    card = smi("name,power.limit")
    cs.log(card)
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import (k8b_layout,
                                                mamba1_scan_bwd_cuda,
                                                mamba1_scan_bwd_ref)
    variants = [Variant(lay, _build.CSRC / "mamba_scan_bwd.cu",
                        defines_of(lay))
                for lay in args.layouts.split(",") if lay]
    if args.baseline is not None:
        variants.insert(0, Variant("baseline", args.baseline, {}))
    build([v for v in variants if v.tag != "baseline"], "k8b_variants",
          LAUNCHES, sass=True)
    build([v for v in variants if v.tag == "baseline"], "k8b_variants",
          LAUNCHES[:1], sass=True)
    inputs = {dt: cs.scan_backward_inputs(dev, dt)
              for dt in ("bfloat16", "float32")}
    want = {dt: mamba1_scan_bwd_ref(*a) for dt, a in inputs.items()}
    torch.cuda.synchronize()
    x = inputs["bfloat16"]
    B, L, D = x[0].shape
    N = x[4].shape[1]
    bound = cs.k8b_bound(B, L, D, N, cs.sm_clock_hz())
    rows = []
    for v in variants:
        base = v.tag == "baseline"
        use(None if base else v)
        call = ((lambda a: baseline_call(v, a)) if base
                else (lambda a: mamba1_scan_bwd_cuda(*a)))
        row = {"k8b_layout": v.tag, "defines": v.defines,
               **path_report(v.ptxas), "card": card}
        if not base:
            row["layout"] = layout_of(v)
        row["sass"] = sass_mix(v.sass, 1 if base else row["layout"]["lanes"])
        if args.sass is not None:
            args.sass.mkdir(parents=True, exist_ok=True)
            (args.sass / f"k8b_{v.tag}.sass").write_text(path_sass(v.sass))
        errs, fails = {}, []
        for dt, a in inputs.items():
            got = call(a)
            torch.cuda.synchronize()
            errs[dt], bad = checked(cs.grads_held, got, want[dt], dt,
                                    f"K8b {v.tag} {dt}", (2, 3, 4))
            if bad:
                fails.append(f"{dt}: {bad}")
            if not base:
                again = call(a)
                torch.cuda.synchronize()
                same = all(g is None and w is None or torch.equal(g, w)
                           for g, w in zip(got, again))
                row[f"bit_equal_{dt}"] = same
                if not same:
                    fails.append(f"{dt}: two calls differ")
                del again
            del got
        run = lambda: call(x)  # noqa: E731
        row.update({"max_abs_err": errs, "failed": fails,
                    "ms": cs.device_ms(run, None, reps=5),
                    "kernel_ms": cs.device_ms(run, "scan_bwd_kernel<",
                                              reps=5),
                    "call_ms": cs.cuda_ms(run, reps=3)})
        row["share_of_bound"] = bound["bound_ms"] / row["ms"]
        rows.append(row)
        cs.log(json.dumps(row))
        torch.cuda.empty_cache()
    use(None)
    ok = [r for r in rows if r["k8b_layout"] != "baseline" and not
          r["failed"]]
    base = next((r for r in rows if r["k8b_layout"] == "baseline"), None)
    summary = {"k8b_layouts_card": card, "shipped": k8b_layout(), **bound,
               "baseline_ms": base["ms"] if base else None,
               "baseline_source": str(args.baseline) if base else None,
               "fastest": (min(ok, key=lambda r: r["ms"])["k8b_layout"]
                           if ok else None)}
    cs.log(json.dumps(summary))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"rows": rows, "summary": summary},
                                   indent=1))


if __name__ == "__main__":
    main()
