"""Whether cuBLAS's bf16 product gives a row the same bits however many rows
a call has, at falcon-mamba-7b's projection shapes, and what the ssm
decode's padded products (``ops.batch_invariant_matmul``) change.

For each projection (K, N) it draws random bf16 activations of 8,320 rows
(4 × 2,080, the teacher-forced forward of ``chip_smoke.py`` phase 4e) and
weights scaled by K^-1/2, and prints the share of the first m rows' results
that differ from the same rows of the 8,320-row product, for m from 4 (a
decode step at batch 4) to 8,192, plainly and through
``batch_invariant_matmul``. Prints one JSON line a projection and the card's
name and power limit; exits 1 without a card.

    python3 tools/gemm_rows.py
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# (name, K, N) at falcon-mamba-7b's width: d 4096, d_inner 8192, dt_rank
# 256, N 16, vocab 65024
SHAPES = [("in_proj", 4096, 16384), ("x_proj", 8192, 288),
          ("dt_proj", 256, 8192), ("out_proj", 8192, 4096),
          ("unembed", 4096, 65024)]
ROWS = [4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("gemm_rows: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels.ops import batch_invariant_matmul
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, K, N in SHAPES:
            w = (torch.randn((K, N), device=dev, generator=gen)
                 * K ** -0.5).bfloat16()
            a = torch.randn((8320, K), device=dev, generator=gen).bfloat16()
            ref = a @ w
            plain, padded = {}, {}
            for m in ROWS:
                plain[m] = float((a[:m] @ w != ref[:m]).float().mean())
                padded[m] = float((batch_invariant_matmul(a[:m], w)
                                   != ref[:m]).float().mean())
            print(json.dumps({"gemm_rows": name, "K": K, "N": N,
                              "differing_share": plain,
                              "differing_share_padded": padded,
                              "card": card}), flush=True)


if __name__ == "__main__":
    main()
