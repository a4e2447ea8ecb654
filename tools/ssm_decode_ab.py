"""What the ssm decode's two exactness measures cost and buy on the card:
the padded products (``ops.batch_invariant_matmul`` on x_proj and
out_proj) and K8's arithmetic (shipped: each product and sum rounded on
its own, Σ_n as the pairwise tree; fused: h's update as one fmaf, the same
tree).

The fused arithmetic is ``csrc/mamba_scan.cu`` built with
``-DK8_FUSED=1`` into a library of its own under ``build/``
(``k8_layouts.build_variants``), and stands in for the shipped kernel by
replacing ``mamba1_scan_launch`` in the loaded library
(``_variants.use``). Then, in one process:

1. K8 at ``chip_smoke.py`` phase 4e's shape (B 4, L 2048, D 8192, N 16,
   bf16 in, float32 y and h_last) and at the float32 B 2 shape, device time
   by the profiler, read rounded, fused, fused, rounded, the rounded held
   bit-equal to the plain version and the fused at 1e-5;
2. falcon-mamba-7b at full width and depth (seed 0, prompts from seed 1,
   B 4 × 2048, 32 greedy decode steps): phase 4e's check (iii), the decode
   logits against a teacher-forced forward, for products padded or plain
   and each arithmetic (the decode step is the shipped plain ops);
3. the host's time to enqueue one x_proj or out_proj product at decode's
   shapes, for each form of the product (``product_forms``: padded as
   shipped, padded with zero-filled rows, plain);
4. with the shipped arithmetic, 32 decode steps after a prefill timed on
   the host's clock for each form, the order turned every round over
   ``ROUNDS`` rounds, and in the first two rounds one decode step's device
   time, its matrix products' share and its launches by the profiler
   (``chip_smoke.device_breakdown``).

Prints one JSON line a reading and the card's name and power limit; exits
1 without a card.

    python3 tools/ssm_decode_ab.py
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

from _variants import Variant  # noqa: E402
from _variants import use as use_variant  # noqa: E402
from k8_layouts import build_variants  # noqa: E402

ROUNDS = 8


def fused_variant():
    """K8 with the fused arithmetic, built from the shipped source (the
    shipped one is held bit-equal to the plain version, so a source built
    fused by default fails there)."""
    from repro_torch.kernels import _build
    v = Variant("fused", _build.CSRC / "mamba_scan.cu", {"K8_FUSED": 1})
    build_variants([v], sass=False)
    return v


def use(arith: str, fused) -> None:
    use_variant(fused if arith == "fused" else None)


def zero_rows(x, w):
    """The padded product with the rows added zero-filled (``F.pad``), as
    the shipped one was before it left them unwritten."""
    import torch.nn.functional as F
    from repro_torch.kernels.ops import INVARIANT_ROWS
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    if n >= INVARIANT_ROWS:
        return x @ w
    padded = F.pad(flat, (0, 0, 0, INVARIANT_ROWS - n))
    return (padded @ w)[:n].reshape(*x.shape[:-1], w.shape[1])


def product_forms():
    """The decode's x_proj/out_proj product: as shipped (padded to
    ``ops.INVARIANT_ROWS`` rows, the rows added unwritten), with the rows
    added zero-filled, and plain."""
    from repro_torch.kernels import ops
    return {"padded": ops.batch_invariant_matmul, "zero_rows": zero_rows,
            "plain": lambda x, w: x @ w}


def use_products(fn) -> None:
    from repro_torch.kernels import ops
    ops.batch_invariant_matmul = fn


def host_readings(dev, forms, card) -> None:
    """Host µs to enqueue one product at decode's shapes (B 4, one token),
    each form over ``reps`` calls, read in the order plain, padded,
    zero_rows, zero_rows, padded, plain; and whether the two padded forms
    give the same bits."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(5)
    reps = 200
    for name, K, N in (("x_proj", 8192, 288), ("out_proj", 8192, 4096)):
        w = (torch.randn((K, N), generator=gen, device=dev)
             * K ** -0.5).bfloat16()
        x = torch.randn((4, 1, K), generator=gen, device=dev).bfloat16()
        same = torch.equal(forms["padded"](x, w), forms["zero_rows"](x, w))
        row = {"host_us": name, "reps": reps, "same_bits": same,
               "us": {k: [] for k in forms}, "card": card}
        for form in ("plain", "padded", "zero_rows", "zero_rows", "padded",
                     "plain"):
            fn = forms[form]
            fn(x, w)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                fn(x, w)
            row["us"][form].append((time.perf_counter() - t) * 1e6 / reps)
            torch.cuda.synchronize()
        cs.log(json.dumps(row))


def k8_readings(dev, fused) -> None:
    import torch
    from repro_torch.kernels.mamba_scan import (mamba1_scan_cuda,
                                                mamba1_scan_ref)
    for shape, kw in (("phase 4e: B 4, bf16 in, float32 y and h_last",
                       dict(dtype="bfloat16", B=4)),
                      ("B 2, float32, no state", dict(dtype="float32"))):
        args = cs.mamba_inputs(dev, **kw)
        call = dict(return_state=True, y_dtype=torch.float32) \
            if kw["dtype"] == "bfloat16" else {}
        want = mamba1_scan_ref(*args, **call)
        want = want if isinstance(want, tuple) else (want,)
        row = {"k8_ab": shape, "order": ["rounded", "fused", "fused",
                                         "rounded"],
               "ms": [], "max_abs_err": {}}
        for arith in row["order"]:
            use(arith, fused)
            got = mamba1_scan_cuda(*args, **call)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            row["max_abs_err"][arith] = max(
                cs.bitwise(g, w, f"K8 {arith} {shape}") if arith == "rounded"
                else cs.held(g, w, cs.TOL["float32"], f"K8 {arith} {shape}")
                for g, w in zip(got, want))
            row["ms"].append(cs.device_ms(
                lambda: mamba1_scan_cuda(*args, **call), "scan_kernel",
                reps=10))
        use("rounded", fused)
        cs.log(json.dumps(row))
        del args, want, got
        torch.cuda.empty_cache()


def decode_check(model, cfg, prompts) -> dict:
    """``chip_smoke.lm_path``'s check (iii): relative L2 of the decode
    logits against a teacher-forced forward, and the greedy tokens'
    agreement."""
    import torch
    from repro_torch.models import model as M
    B, S = prompts.shape
    G = cs.LM_GEN
    logits, cache, _ = M.prefill(model, prompts, cfg, max_seq=S + G)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    del logits
    toks, dec = [tok], []
    for _ in range(G):
        lg, cache = M.decode_step(model, tok, cache, cfg)
        dec.append(lg.float())
        tok = lg.argmax(-1).to(torch.int32)
        toks.append(tok)
    del cache
    dec = torch.stack(dec, dim=1)
    gen = torch.stack(toks, dim=1)
    full, _ = M.forward(model, torch.cat([prompts, gen[:, :G]], dim=1), cfg)
    tf = full[:, S:].float()
    del full
    rel = float(torch.linalg.vector_norm(dec - tf)
                / torch.linalg.vector_norm(tf))
    agree = float((tf.argmax(-1) == gen[:, 1:]).float().mean())
    return {"decode_vs_teacher_forced_rel_l2": rel,
            "teacher_forced_token_agreement": agree}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("ssm_decode_ab: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(card)
    dev = torch.device("cuda")
    fused = fused_variant()
    forms = product_forms()
    with torch.no_grad():
        k8_readings(dev, fused)
        host_readings(dev, forms, card)
        cfg = get_config("falcon-mamba-7b")
        model = M.init_params(cfg, seed=0, device=dev)
        B, S, G = cs.LM_BATCH, cs.LM_PROMPT, cs.LM_GEN
        prompts = torch.randint(0, cfg.vocab, (B, S), device=dev,
                                dtype=torch.int32,
                                generator=torch.Generator(device=dev)
                                .manual_seed(1))
        for products in ("padded", "plain"):
            for arith in ("rounded", "fused"):
                use_products(forms[products])
                use(arith, fused)
                cs.log(json.dumps({"check_iii": {
                    "products": products, "k8": arith,
                    **decode_check(model, cfg, prompts)}, "card": card}))
        use("rounded", fused)
        prefill = make_prefill_step(cfg, max_seq=S + G)
        decode = make_decode_step(cfg)
        times = {k: [] for k in forms}
        step_ms = {k: [] for k in forms}
        order = list(forms)
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                use_products(forms[name])
                tok, cache = prefill(model, {"inputs": prompts})
                for _ in range(2):                  # warm-up
                    tok, cache = decode(model, tok, cache)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(G):
                    tok, cache = decode(model, tok, cache)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3 / G)
                if r < 2:
                    bd = cs.device_breakdown(
                        lambda: decode(model, tok, cache), times[name][-1],
                        [("k8", "scan_kernel")])
                    step_ms[name].append({"device_ms": bd["device_ms"],
                                          "gemm_ms": bd["by_kind_ms"]["gemm"],
                                          "launches": bd["kernel_launches"]})
                del cache
        use_products(forms["padded"])
        cs.log(json.dumps({"decode_ab": "falcon-mamba-7b, B 4, 32 steps "
                           "after a 2048-token prefill, "
                           "rounded K8", "rounds": ROUNDS,
                           "ms_per_token": times,
                           "device_ms_per_step": step_ms, "card": card}))


if __name__ == "__main__":
    main()
