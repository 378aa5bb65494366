"""Quickstart on the PyTorch port: build any of the 10 architectures,
take one train step, prefill + decode a few tokens (the port's
counterpart of examples/quickstart.py).

  PYTHONPATH=src python examples_torch/quickstart.py --arch qwen3-8b
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu

``run(cfg, params, inputs, device)`` is the script without its weights
and inputs: one ``make_train_step`` step on ``inputs["train_tokens"]``
([2, 64]), then ``lm.prefill`` of ``inputs["prompt"]`` ([1, 16]) at
cache_len 32 and 8 greedy ``lm.decode_step``s. It returns what the
script prints, with each decoded token's top-1/top-2 logit margin, so a
caller holding two runs to each other knows which tokens are near ties.
The script runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_NAMES, SMOKE_CONFIGS
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import leaves
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step

TRAIN_SHAPE = (2, 64)
PROMPT_LEN = 16
CACHE_LEN = 32
DECODE_STEPS = 8
OPT = AdamWConfig(lr=1e-3)


def make_inputs(vocab_size: int, seed: int = 1) -> dict:
    """The train batch and the prompt, token ids in [0, vocab_size)."""
    rng = np.random.default_rng(seed)
    return {"train_tokens": rng.integers(0, vocab_size, size=TRAIN_SHAPE,
                                         dtype=np.int32),
            "prompt": rng.integers(0, vocab_size, size=(1, PROMPT_LEN),
                                   dtype=np.int32)}


def _top1(logits):
    """(argmax, top-1 minus top-2) of one row of logits, on the host."""
    top = torch.topk(logits.float(), 2).values
    return int(torch.argmax(logits)), float(top[0] - top[1])


def run(cfg, params, inputs: dict, device=None) -> dict:
    """One train step (AdamW updates ``params`` in place), then prefill
    and greedy decode with the updated weights."""
    device = resolve_device(device)
    step = make_train_step(cfg, OPT)
    opt = adamw_init(params)
    toks = torch.as_tensor(inputs["train_tokens"], dtype=torch.int32,
                           device=device)
    params, opt, metrics = step(params, opt, toks)
    out = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model,
           "params_m": sum(p.numel() for p in leaves(params)) / 1e6,
           "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"])}
    del opt
    prompt = torch.as_tensor(inputs["prompt"], dtype=torch.int32,
                             device=device)
    logits, state = lm.prefill(params, prompt, cfg, cache_len=CACHE_LEN)
    tok, margin = _top1(logits[0])
    tokens, margins = [tok], [margin]
    for _ in range(DECODE_STEPS):
        logits, state = lm.decode_step(
            params, torch.tensor([tokens[-1]], dtype=torch.int32,
                                 device=device), state, cfg)
        tok, margin = _top1(logits[0])
        tokens.append(tok)
        margins.append(margin)
    out.update(tokens=tokens, margins=margins)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list(ARCH_NAMES))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = SMOKE_CONFIGS[args.arch]      # reduced config of the same family
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model}")
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init_params(cfg, gen, device=device)
    print(f"params: {sum(p.numel() for p in leaves(params)) / 1e6:.2f}M "
          f"(reduced smoke config)")
    out = run(cfg, params, make_inputs(cfg.vocab_size), device)
    print(f"train_step: loss={out['loss']:.4f} "
          f"grad_norm={out['grad_norm']:.4f}")
    print("decoded tokens:", out["tokens"])
    print("ok")
    return out


if __name__ == "__main__":
    main()
