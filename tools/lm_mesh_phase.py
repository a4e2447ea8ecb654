"""Phase 4l of ``chip_smoke.py`` alone: the LM half of the multi-device
backend on a world of one NCCL rank, at full width and depth.

For llama3-8b and falcon-mamba-7b in turn it draws the weights on the card
(seed 0) and the 4 × 2048 prompts (seed 1) as phases 4d and 4e do, serves
them unsharded (a warm-up, then a timed prefill and 32 greedy decode
steps), then runs ``chip_smoke.lm_mesh_path`` on the same weights: cut in
place to a (1, 1) ('data', 'model') mesh, served through the serve steps
with ``mesh=``, its tokens held equal to the unsharded run's, K7 or K8
launched once a prefill layer and never in decode, one ``lm_mesh`` line.
Then ``chip_smoke.check_tp8_shapes``: K7 and K8 against their plain
versions at a TP-8 rank's shapes. Prints the card's name and power limit
first, and exits 1 without a card.

    python3 tools/lm_mesh_phase.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main() -> None:
    dev = cs.environment()
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)
    _build.build()
    _build.library()
    t_phase = time.perf_counter()
    launches = dict.fromkeys(_build.launches, 0)
    for arch, op, _, _ in cs.LM_PATHS:
        cfg = get_config(arch)
        B, S, G = cs.LM_BATCH, cs.LM_PROMPT, cs.LM_GEN
        model = M.init_params(cfg, seed=0, device=dev)
        prompts = torch.randint(0, cfg.vocab, (B, S), device=dev,
                                dtype=torch.int32,
                                generator=torch.Generator(device=dev)
                                .manual_seed(1))
        prefill = make_prefill_step(cfg, max_seq=S + G)
        decode = make_decode_step(cfg)
        tok, cache = prefill(model, {"inputs": prompts})     # warm-up
        for _ in range(2):
            tok, cache = decode(model, tok, cache)
        torch.cuda.synchronize()
        del cache
        t = time.perf_counter()
        tok, cache = prefill(model, {"inputs": prompts})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        toks = [tok]
        t = time.perf_counter()
        for _ in range(G):
            tok, cache = decode(model, tok, cache)
            toks.append(tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t) * 1e3 / G
        del cache
        cs.lm_mesh_path(dev, model, cfg, prompts, torch.stack(toks, dim=1),
                        op, {"prefill_ms": prefill_ms,
                             "decode_ms_per_token": decode_ms}, launches)
        del model
        torch.cuda.empty_cache()
    cs.check_tp8_shapes(dev)
    print(json.dumps({"lm_mesh_launches": launches,
                      "phase_s": time.perf_counter() - t_phase}), flush=True)


if __name__ == "__main__":
    main()
