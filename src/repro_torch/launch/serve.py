"""Batched serving: prefill a batch of prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --reduced --device cpu --batch 4 --prompt-len 32 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch falcon-mamba-7b --prompt-len 2048

Serves the dense family (K7 in every prefill layer) and the ssm family
(falcon-mamba-7b; K8 in every prefill layer). Runs on the card unless
``--device cpu`` is given. Weights come from a
seeded ``torch.Generator`` (seed 0) on the device, prompts from seed 1.
Prints the prefill time, the decode time per token and the first
sequence's generated tokens.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models import init_params
from repro_torch.training.train_step import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="serve sharded over a mesh (names=shape): not "
                         "ported yet, ROADMAP A8.3")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "serving over a mesh is not ported yet: ROADMAP A8.3 (the LM "
            "half of the multi-device backend)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    max_seq = args.prompt_len + args.gen
    params = init_params(cfg, seed=0, device=device)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32).to(device)
    prefill = make_prefill_step(cfg, max_seq=max_seq)
    decode = make_decode_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    tok, cache = prefill(params, {"inputs": prompts})
    _sync(device)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    _sync(device)
    t_dec = time.perf_counter() - t0
    gen = torch.stack(out, dim=1)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={device}")
    print(f"prefill: {t_prefill*1e3:.1f} ms   decode: "
          f"{t_dec/max(args.gen-1,1)*1e3:.1f} ms/token")
    print("generated token ids (first sequence):", gen[0].tolist())


if __name__ == "__main__":
    main()
