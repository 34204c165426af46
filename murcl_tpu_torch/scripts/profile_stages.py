"""Per-op profile of the sequential stage-2/3 contrastive steps.
(Counterpart of ``scripts/profile_stages.py``.)

``profile_step`` profiles the batched stage-1 step; this attributes the
policy-driven stages op by op the same way: the T-step rollout (stage 2
with the aggregator frozen, in eval mode and without gradients, then one
PPO update per view; stage 3 with the policy fixed, the full backward and
Adam at 1e-4), ``ContrastiveEngine.train_step`` in the traced window. The
build is ``profile_step``'s (the JAX script's bank, CLAM_SB, the GRU head,
batch 128, T 6, bf16) with ``PPO(hidden 1024, action 10, lr 1e-5, gamma
0.1, K_epochs 3)``, and the tables are ``profile_step``'s. For stage 2 the
script also prints the share of the step in the PPO updates' own ops: the
card's ops launched inside the program's ``murcl.ppo_update`` spans (the
host's spans on the CPU).

    python -m murcl_tpu_torch.scripts.profile_stages --stage 2   # cuda:0
    python -m murcl_tpu_torch.scripts.profile_stages --device cpu --stage 2 --shape 4 96 32 64 8 2
"""

from __future__ import annotations

import argparse

from murcl_tpu_torch.scripts.probes import probe_device, where
from murcl_tpu_torch.scripts.profile_step import OUT, SHAPE, build_step, profile_run
from murcl_tpu_torch.scripts.profiling import busy_union_ms, host_events, range_events

UPDATE = "murcl.ppo_update"  # the program's span around PPO.update


def run(device="cuda:0", shape=SHAPE, stage: int = 3, steps: int = 3, out=None) -> dict:
    """Prints the table (and for stage 2 the updates' share) and returns
    ``profile_step.run``'s dict, with ``update_ms`` (the updates' ms per
    step: the union of their device ops, or of their host spans on the
    CPU) and ``update_share`` (of the untraced step) for stage 2."""
    if stage not in (2, 3):
        raise ValueError(f"profile_stages: stage 2 or 3, got {stage}")
    dev = probe_device(device)
    out = out if out is not None else OUT / f"profile_stage{stage}.trace.json"
    s = build_step(dev, shape, stage=stage)
    print(f"profile of the stage-{stage} step, CLAM_SB bf16, batch {shape[4]} of {shape[0]} "
          f"slides x {shape[1]} patches x {shape[2]}, feat_size {shape[3]}, T {shape[5]} "
          f"({where(dev)})", flush=True)
    res = profile_run(s, dev, steps, out, f"stage-{stage} steps")
    if stage == 2:
        prof = res["prof"]
        if res["on_device"]:
            res["update_ms"] = busy_union_ms(range_events(prof, UPDATE)) / steps
        else:
            res["update_ms"] = busy_union_ms(e for e in host_events(prof)
                                             if e.name == UPDATE) / steps
        res["update_share"] = res["update_ms"] / res["step_ms"]
        print(f"\nthe two PPO updates: {res['update_ms']:.2f} "
              f"{'device' if res['on_device'] else 'host'} ms per step, "
              f"{100 * res['update_share']:.2f}% of the untraced {res['step_ms']:.2f} ms step")
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--stage", type=int, default=3, choices=[2, 3])
    ap.add_argument("--shape", type=int, nargs=6, default=list(SHAPE),
                    metavar=("SLIDES", "PATCHES", "D", "FEAT", "BATCH", "T"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="the trace's path (default build/profile/profile_stage<N>.trace.json)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, tuple(a.shape), a.stage, a.steps, a.out)
