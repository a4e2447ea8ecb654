"""End-to-end LM training driver, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --reduced --device cpu --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch h2o-danube-1.8b --steps 20 --batch 4 --seq 2048   # the card

The port of the JAX package's ``launch/train.py``: the same flags and log
lines, plus ``--device`` (default ``cuda``). Full configs train in mixed
precision (bf16 model, float32 master and moments), ``--reduced`` ones in
float32. The weights are drawn from seed 0 (the port's generator, not
JAX's draws). ``--ckpt-dir`` saves the train state every ``--ckpt-every``
steps and at the end through the port's ``Checkpointer(async_save=True)``,
the data stream's state in ``extra``; ``--resume`` continues from the
newest snapshot. Training on a mesh (``--mesh``) is ROADMAP A10.2b.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models import model as M
from repro_torch.training import optimizer as O
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.data import DataCfg, make_dataset
from repro_torch.training.train_step import make_train_step


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None,
                    help="training on a mesh is ROADMAP A10.2b")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "training on a mesh (FSDP and data-parallel gradient reductions "
            "over torch.distributed) is not ported yet: ROADMAP A10.2b")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = O.OptCfg(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                       total_steps=args.steps,
                       grad_compress_bf16=args.grad_compress,
                       mixed_precision=not args.reduced)

    model = M.init_params(cfg, seed=0, device=device)
    n_params = M.param_count(model)
    state = O.init_state(model, opt_cfg)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M mesh=single-device")

    data = make_dataset(DataCfg(batch=args.batch, seq=args.seq,
                                vocab=cfg.vocab))

    ck = Checkpointer(args.ckpt_dir, async_save=True) if args.ckpt_dir else None
    start = 0
    if ck and args.resume and ck.latest_step() is not None:
        tree, start = ck.restore(O.state_tree(state), device=device)
        O.load_state_tree(state, tree)
        data.restore(ck.extra()["data"])
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, opt_cfg)
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in next(data).items()}
            state, metrics = step_fn(state, batch)
            if (i + 1) % args.log_every == 0 or i == start:
                dt = (time.time() - t0) / max(i + 1 - start, 1)
                print(f"step {i+1:5d} loss={float(metrics['loss']):.4f} "
                      f"ce={float(metrics['ce']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f} ms/step")
            if ck and (i + 1) % args.ckpt_every == 0:
                ck.save(O.state_tree(state), i + 1,
                        extra={"data": data.state()})
        if ck:
            ck.save(O.state_tree(state), args.steps,
                    extra={"data": data.state()})
    finally:
        if ck:      # a run that stops leaves its last snapshot whole
            ck.wait()
    print("done.")


if __name__ == "__main__":
    main()
