#!/usr/bin/env python3
"""Train a small LM with the port's full training substrate: AdamW + the
schedule, the deterministic token pipeline, checkpoint/restart and the
straggler watchdog (the port's twin of ``examples/train_lm.py``, same
flags, plus ``--device``).  Interrupt it (Ctrl-C) and re-run: it resumes
where it stopped.

    PYTHONPATH=src python tools/train_lm.py --steps 300 --arch qwen1.5-0.5b
    PYTHONPATH=src python tools/train_lm.py --steps 40 --device cpu

Checkpoints go under ``build/train_lm_ckpt`` beside this script's
checkout unless ``--ckpt`` says otherwise.
"""
import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.train import loop as loop_lib, optimizer as opt_lib  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "build", "train_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    cfg = get(args.arch + "-smoke")
    cfg = dataclasses.replace(
        cfg, n_layers=args.layers, d_model=args.d_model,
        n_heads=8, n_kv_heads=8, head_dim=32,
        d_ff=4 * args.d_model if cfg.d_ff else 0, vocab=1024,
        attn_chunk_q=32, attn_chunk_k=32)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    opt = opt_lib.AdamW(schedule=opt_lib.Schedule(
        peak_lr=3e-3, warmup_steps=20, decay_steps=args.steps))
    lc = loop_lib.LoopConfig(total_steps=args.steps, ckpt_every=50,
                             ckpt_dir=args.ckpt)

    def on_step(step, loss):
        if step % 20 == 0:
            print(f"step {step:5d}  loss {loss:.4f}", flush=True)

    rep = loop_lib.run(cfg, pipe, lc, optimizer=opt, hooks={"on_step": on_step},
                       device=args.device)
    print(f"done: {rep.final_step} steps"
          + (f" (resumed from {rep.resumed_from})" if rep.resumed_from else ""))
    if rep.losses:
        print(f"loss {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}; "
              f"stragglers flagged: {rep.straggler_steps}")
    return rep


if __name__ == "__main__":
    main()
