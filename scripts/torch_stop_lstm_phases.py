"""The capture and stop-LSTM phases of ``chip_smoke.py`` alone, on one
NVIDIA GPU, at full width:

    python3 scripts/torch_stop_lstm_phases.py

Builds the kernels, then runs ``chip_smoke.learning_check`` (ppo_v2_0 f32,
20 iterations through ``train_ppo`` with the trajectory capture, beside a
run without it), ``chip_smoke.stop_lstm_phase`` (the two reference
trainers on the captured episodes, held to the CPU and profiled, then eval
A with each LSTM gate, held to the CPU) and ``chip_smoke.check_stop_cli``,
and prints their JSON record and each part's seconds.  Exits 1 without a
card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_stop_lstm_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from tpu_plume_torch.cli.main import main as cli_main
    from tpu_plume_torch.core.config import get_preset
    from tpu_plume_torch.evaluation import harnesses as ev
    from tpu_plume_torch.fields import gridded
    from tpu_plume_torch.ops import build, gather, plume
    from tpu_plume_torch.ops import ppo as fused_ops
    from tpu_plume_torch.train import ppo_trainer as ttrain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cs.build_kernels(build, ("plume", "ppo", "gather"))
    k = types.SimpleNamespace(plume=plume, fused_ops=fused_ops,
                              gather=gather, gridded=gridded)
    cfg = get_preset("ppo_v2_0")
    cfg = cfg.replace(ppo=dataclasses.replace(cfg.ppo,
                                              minibatch_size=cs.MAIN_MB))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        learn_dir = os.path.join(tmp, "learn")
        learning, res, trained = cs.learning_check(ttrain, ev, k, cfg,
                                                   learn_dir)
        t1 = time.perf_counter()
        out, ckpts = cs.stop_lstm_phase(ev, k, cfg, trained, res, tmp)
        t2 = time.perf_counter()
        out["cli"] = cs.check_stop_cli(cli_main, learn_dir, ckpts, tmp)
        t3 = time.perf_counter()
    out["capture"] = learning["capture"]
    print(json.dumps({"stop_lstm": out}))
    print(f"phase seconds: learning {t1 - t0:.1f}, stop_lstm {t2 - t1:.1f}, "
          f"cli {t3 - t2:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
