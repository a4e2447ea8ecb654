"""Phase 4n of ``chip_smoke.py`` alone: training on one card, and the
K7b and K8b rows of its phase 5.

h2o-danube-1.8b at full width and depth and falcon-mamba-7b at full width
cut to 16 layers train through ``make_train_step`` (mixed-precision AdamW,
remat) on ``SyntheticLM`` batches of 4 × 2048, 2 warm-up and 10 timed
steps each (``chip_smoke.train_path``: the loss finite and falling, K7 and
K7b or K8 and K8b launched as many times a step as the layers ask, one
``train`` line each with the step's device breakdown); then each family's
2-layer float32 cut against the CPU, K7b and K8b against their plain
versions at the training shapes, and the two kernels' rows. Prints the
card's name and power limit first, and exits 1 without a card.

    python3 tools/training_phase.py
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
    from repro_torch.kernels import _build
    t = time.perf_counter()
    _build.build()
    _build.library()
    cs.log(f"build: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    launches, k7b_err, k8b_err = cs.training_phase(dev)
    rows = [cs.k7b_times(dev, launches, k7b_err),
            cs.k8b_times(dev, launches, k8b_err, cs.sm_clock_hz())]
    print(json.dumps({"kernels": rows, "train_launches": launches,
                      "phase_s": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
