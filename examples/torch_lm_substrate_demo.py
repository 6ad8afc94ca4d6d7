"""LM substrate demo on the port: train a reduced config of each assigned
architecture for a few steps (the training half of
``examples/lm_substrate_demo.py``; its greedy decode is not ported yet).

    PYTHONPATH=src python examples/torch_lm_substrate_demo.py [--arch llama3-8b]

Runs on the card by default; ``--device cpu`` runs on the CPU.
"""
import argparse

import torch

from repro_torch.configs import LM_ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import lm_train_batch
from repro_torch.models import init_params, make_train_step
from repro_torch.train.adam import adam_init


def demo(arch: str, steps: int = 5, device="cuda") -> list:
    """``steps`` train steps of ``arch``'s SMOKE config on batches of 4 x 64
    synthetic tokens (whisper: 0.3-scaled random frames, internvl2: a
    0.3-scaled random patch prefix); prints and returns the losses."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, cfg)
    opt = adam_init(params)
    train = make_train_step(cfg, num_microbatches=1)
    b, s = 4, 64
    losses = []
    for i in range(steps):
        batch = lm_train_batch(cfg, gen, b, s, dev)
        for key in ("frames", "patch_embeds"):
            if key in batch:
                batch[key] = batch[key] * 0.3
        params, opt, loss = train(params, opt, batch)
        losses.append(float(loss))
        print(f"  [{arch}] train step {i}: loss={losses[-1]:.4f}", flush=True)
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="one arch id (default: all ten)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    archs = [args.arch] if args.arch else list(LM_ARCHS)
    for arch in archs:
        print(f"== {arch} ==")
        demo(arch, steps=args.steps, device=args.device)


if __name__ == "__main__":
    main()
