"""Batched serving: prefill a batch of prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --reduced --device cpu --batch 4 --prompt-len 32 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch falcon-mamba-7b --prompt-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --reduced --device cpu --mesh data,model=2,2

Serves the dense family (K7 in every prefill layer) and the ssm family
(falcon-mamba-7b; K8 in every prefill layer). Runs on the card unless
``--device cpu`` is given. Weights come from a
seeded ``torch.Generator`` (seed 0) on the device, prompts from seed 1.
Prints the prefill time, the decode time per token and the first
sequence's generated tokens.

``--mesh names=shape`` serves sharded over a mesh of ``prod(shape)``
ranks (``models.sharding``): this process starts one process a rank
(``launch.mesh.launch_ranks``, every rank under one deadline; gloo ranks
on the CPU, one NCCL rank a card on ``cuda``), each rank draws the same
weights and keeps its block, feeds its rows of the prompts, and rank 0
prints. The tokens are the unsharded run's.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models import init_params
from repro_torch.models import sharding as sh
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
                    help="serve sharded over a mesh, names=shape (e.g. "
                         "data,model=2,2): one process a rank")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    names, shape = _parse_mesh(args.mesh)
    if args.mesh and args.rank is None:
        from repro_torch.launch.mesh import launch_ranks
        print(launch_ranks("repro_torch.launch.serve",
                           list(argv if argv is not None else sys.argv[1:]),
                           math.prod(shape), args.device), end="")
        return

    mesh = None
    if args.rank is not None:
        from repro_torch.launch.mesh import init_rank
        if args.device == "cpu":
            torch.set_num_threads(1)      # the ranks share the cores
        mesh = init_rank(args.rank, math.prod(shape), args.rendezvous,
                         args.device, shape=shape, axes=names)
    try:
        _serve(args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _parse_mesh(text):
    """``'data,model=2,2'`` -> (('data', 'model'), (2, 2)); None -> ((),
    ())."""
    if not text:
        return (), ()
    names, shape = text.split("=")
    names = tuple(names.split(","))
    shape = tuple(int(x) for x in shape.split(","))
    if len(names) != len(shape):
        raise ValueError(f"--mesh {text}: {len(names)} names, "
                         f"{len(shape)} sizes")
    return names, shape


def _serve(args, mesh) -> None:
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    max_seq = args.prompt_len + args.gen
    params = init_params(cfg, seed=0, device=device, mesh=mesh)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32).to(device)
    with sh.use(mesh):
        prompts = prompts[sh.batch_rows(args.batch)]
    prefill = make_prefill_step(cfg, max_seq=max_seq, mesh=mesh)
    decode = make_decode_step(cfg, mesh=mesh)

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
    if mesh is not None and args.rank != 0:
        return
    where = f" mesh={args.mesh}" if mesh is not None else ""
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={device}{where}")
    print(f"prefill: {t_prefill*1e3:.1f} ms   decode: "
          f"{t_dec/max(args.gen-1,1)*1e3:.1f} ms/token")
    print("generated token ids (first sequence):", gen[0].tolist())


if __name__ == "__main__":
    main()
