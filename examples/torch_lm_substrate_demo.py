"""LM substrate demo on the port: train a reduced config of each assigned
architecture for a few steps and decode from it greedily, as
``examples/lm_substrate_demo.py`` does.

    PYTHONPATH=src python examples/torch_lm_substrate_demo.py [--arch llama3-8b]

Runs on the card by default; ``--device cpu`` runs on the CPU.
"""
import argparse

import torch

from repro_torch.configs import LM_ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import lm_train_batch
from repro_torch.models import (init_cache, init_params, make_serve_step,
                                make_train_step)
from repro_torch.models.transformer import prefill_cross_cache
from repro_torch.train.adam import adam_init


def demo(arch: str, steps: int = 5, device="cuda") -> list:
    """``steps`` train steps of ``arch``'s SMOKE config on batches of 4 x 64
    synthetic tokens (whisper: 0.3-scaled random frames, internvl2: a
    0.3-scaled random patch prefix), then :func:`greedy_decode` from the
    trained params; prints both and returns the losses."""
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
    greedy_decode(arch, cfg, params, gen, dev)
    return losses


def greedy_decode(arch: str, cfg, params: dict, gen: torch.Generator,
                  device, steps: int = 8) -> list:
    """``steps`` greedy tokens for 2 rows from token 0 against a 32-slot
    cache (whisper: the cross cache from 0.3-scaled random frames of 16
    positions); tokens stay on the device until the end. Prints and
    returns row 0's tokens."""
    cache = init_cache(cfg, 2, 32, enc_len=16 if cfg.is_encdec else 0,
                       device=device)
    if cfg.is_encdec:
        frames = torch.randn((2, 16, cfg.d_model), generator=gen,
                             device=device) * 0.3
        cache = prefill_cross_cache(params, cfg, frames, cache)
    serve = make_serve_step(cfg)
    toks = torch.zeros((2,), dtype=torch.int32, device=device)
    out = []
    for pos in range(steps):
        logits, cache = serve(params, cache, toks, pos)
        toks = torch.argmax(logits[:, : cfg.vocab_size], dim=-1).to(
            torch.int32)
        out.append(toks[0])
    out = torch.stack(out).tolist()
    print(f"  [{arch}] greedy decode: {out}", flush=True)
    return out


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
